"""BFV integer SIMD on the port: exact packed arithmetic.

Counterpart of `examples/simple_integers.py` (reference:
src/pke/examples/simple-integers.cpp), on the GPU unless `--device cpu`:

    python examples_torch/simple_integers.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from openfhe_tpu_torch import (CCParams, GenCryptoContext,  # noqa: E402
                               PKESchemeFeature, Scheme, SecurityLevel)


def main(device=None, plaintext_modulus=65537, mult_depth=2,
         ring_dim=1 << 12, security_level=SecurityLevel.HEStd_NotSet,
         seed=0) -> dict:
    """Add and multiply two packed vectors under BFV; returns the
    decryptions and what they should be."""
    params = CCParams(scheme=Scheme.BFVRNS_SCHEME,
                      plaintext_modulus=plaintext_modulus,
                      mult_depth=mult_depth, ring_dim=ring_dim,
                      security_level=security_level)
    cc = GenCryptoContext(params, seed=seed, device=device)
    cc.Enable(PKESchemeFeature.PKE)
    cc.Enable(PKESchemeFeature.KEYSWITCH)
    cc.Enable(PKESchemeFeature.LEVELEDSHE)

    keys = cc.KeyGen()
    cc.EvalMultKeyGen(keys.secret_key)

    v1 = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12])
    v2 = np.array([3, 2, 1, 4, 5, 6, 7, 8, 9, 10, 11, 12])
    c1 = cc.Encrypt(keys.public_key, cc.MakePackedPlaintext(v1))
    c2 = cc.Encrypt(keys.public_key, cc.MakePackedPlaintext(v2))

    c_add = cc.EvalAdd(c1, c2)
    c_mult = cc.EvalMult(c1, c2)

    add = np.asarray(cc.Decrypt(keys.secret_key, c_add).values)[:12]
    mul = np.asarray(cc.Decrypt(keys.secret_key, c_mult).values)[:12]
    print("v1+v2:", add, "exact:", np.array_equal(add, v1 + v2))
    print("v1*v2:", mul, "exact:", np.array_equal(mul, v1 * v2))
    return {"add": add, "mul": mul, "want_add": v1 + v2,
            "want_mul": v1 * v2}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
