"""Depth-3 BGV on the port: (a*b*c) + (a*b) under two scaling techniques.

Counterpart of `examples/depth_bgvrns.py` (reference:
src/pke/examples/depth-bgvrns.cpp), on the GPU unless `--device cpu`:

    python examples_torch/depth_bgvrns.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from examples_torch import exact  # noqa: E402
from openfhe_tpu_torch import (CCParams, GenCryptoContext,  # noqa: E402
                               PKESchemeFeature, ScalingTechnique, Scheme,
                               SecurityLevel)


def main(device=None, plaintext_modulus=12289, mult_depth=3,
         ring_dim=1 << 10, security_level=SecurityLevel.HEStd_NotSet,
         seed=7) -> dict:
    """The program under FIXEDAUTO and FLEXIBLEAUTO; returns each
    decryption beside what it should be."""
    t = plaintext_modulus
    checks = {}
    for tech in (ScalingTechnique.FIXEDAUTO, ScalingTechnique.FLEXIBLEAUTO):
        params = CCParams(scheme=Scheme.BGVRNS_SCHEME, plaintext_modulus=t,
                          mult_depth=mult_depth, ring_dim=ring_dim,
                          security_level=security_level,
                          scaling_technique=tech)
        cc = GenCryptoContext(params, seed=seed, device=device)
        for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
                  PKESchemeFeature.LEVELEDSHE):
            cc.Enable(f)
        keys = cc.KeyGen()
        cc.EvalMultKeyGen(keys.secret_key)
        a = np.array([1, 2, 3, 4, 5, 6, 7, 8], dtype=np.int64)
        b = np.array([8, 7, 6, 5, 4, 3, 2, 1], dtype=np.int64)
        c = np.array([2, 2, 3, 3, 4, 4, 5, 5], dtype=np.int64)
        ca = cc.Encrypt(keys.public_key, cc.MakePackedPlaintext(a))
        cb = cc.Encrypt(keys.public_key, cc.MakePackedPlaintext(b))
        ctc = cc.Encrypt(keys.public_key, cc.MakePackedPlaintext(c))
        res = cc.EvalAdd(cc.EvalMult(cc.EvalMult(ca, cb), ctc),
                         cc.EvalMult(ca, cb))
        got = np.asarray(cc.Decrypt(keys.secret_key, res).values[:8]) % t
        want = (a * b * c + a * b) % t
        print(f"{tech.name}: exact={np.array_equal(got, want)}")
        assert np.array_equal(got, want)
        checks[tech.name] = exact(got, want)
    print("OK")
    return {"checks": checks}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
