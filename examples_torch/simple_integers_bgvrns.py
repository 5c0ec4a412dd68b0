"""BGV integer SIMD on the port: packed additions, products and rotations.

Counterpart of `examples/simple_integers_bgvrns.py` (reference:
src/pke/examples/simple-integers-bgvrns.cpp), on the GPU unless
`--device cpu`:

    python examples_torch/simple_integers_bgvrns.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from examples_torch import exact  # noqa: E402
from openfhe_tpu_torch import (CCParams, GenCryptoContext,  # noqa: E402
                               PKESchemeFeature, Scheme, SecurityLevel)


def main(device=None, plaintext_modulus=12289, mult_depth=2,
         ring_dim=1 << 10, security_level=SecurityLevel.HEStd_NotSet,
         seed=8) -> dict:
    """Sum and product of three packed vectors, rotations by +-1; returns
    each decryption beside what it should be (mod t). `ring_dim=0` lets
    the security tables choose N."""
    t = plaintext_modulus
    params = CCParams(scheme=Scheme.BGVRNS_SCHEME, plaintext_modulus=t,
                      mult_depth=mult_depth, ring_dim=ring_dim,
                      security_level=security_level)
    cc = GenCryptoContext(params, seed=seed, device=device)
    for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
              PKESchemeFeature.LEVELEDSHE):
        cc.Enable(f)
    print(f"BGV ring dimension {cc.GetRingDimension()}, t = {t}")
    keys = cc.KeyGen()
    cc.EvalMultKeyGen(keys.secret_key)
    cc.EvalRotateKeyGen(keys.secret_key, [1, 2, -1, -2])

    v1 = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12], dtype=np.int64)
    v2 = np.array([3, 2, 1, 4, 5, 6, 7, 8, 9, 10, 11, 12], dtype=np.int64)
    v3 = np.array([1, 2, 5, 2, 5, 6, 7, 8, 9, 10, 11, 12], dtype=np.int64)
    c1 = cc.Encrypt(keys.public_key, cc.MakePackedPlaintext(v1))
    c2 = cc.Encrypt(keys.public_key, cc.MakePackedPlaintext(v2))
    c3 = cc.Encrypt(keys.public_key, cc.MakePackedPlaintext(v3))

    add12 = cc.EvalAdd(cc.EvalAdd(c1, c2), c3)
    mul12 = cc.EvalMult(cc.EvalMult(c1, c2), c3)
    rot1 = cc.EvalRotate(c1, 1)
    rotm1 = cc.EvalRotate(c1, -1)

    def dec(ct):
        return np.asarray(cc.Decrypt(keys.secret_key, ct).values[:12])

    # rotations act on a row of N/2 slots; the unfilled slots hold 0
    row = np.zeros(cc.GetRingDimension() // 2, np.int64)
    row[:12] = v1
    out = {"checks": {
        "sum": exact(dec(add12), v1 + v2 + v3),
        "prod": exact(dec(mul12) % t, (v1 * v2 * v3) % t),
        "rot+1": exact(dec(rot1), np.roll(row, -1)[:12]),
        "rot-1": exact(dec(rotm1), np.roll(row, 1)[:12])},
        "ring_dim": cc.GetRingDimension()}
    for label, (got, want, _) in out["checks"].items():
        print(f"{label:>5}: {got}")
    assert np.array_equal(*out["checks"]["sum"][:2])
    assert np.array_equal(*out["checks"]["prod"][:2])
    print("OK")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
