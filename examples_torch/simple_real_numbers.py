"""CKKS basics on the port: encrypt real vectors, add/mult/rotate, decrypt.

Counterpart of `examples/simple_real_numbers.py` (reference:
src/pke/examples/simple-real-numbers.cpp), on the GPU unless
`--device cpu`:

    python examples_torch/simple_real_numbers.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from openfhe_tpu_torch import (CCParams, GenCryptoContext,  # noqa: E402
                               PKESchemeFeature, ScalingTechnique, Scheme,
                               SecurityLevel)


def main(device=None, mult_depth=2, scaling_mod_size=28,
         first_mod_size=30, ring_dim=1 << 12,
         security_level=SecurityLevel.HEStd_NotSet, seed=0) -> dict:
    """Six ops on two encrypted vectors of 8 reals; returns, per op, the
    decryption and what it should be."""
    params = CCParams(scheme=Scheme.CKKSRNS_SCHEME, mult_depth=mult_depth,
                      scaling_mod_size=scaling_mod_size,
                      first_mod_size=first_mod_size, ring_dim=ring_dim,
                      batch_size=8, security_level=security_level,
                      scaling_technique=ScalingTechnique.FLEXIBLEAUTO)
    cc = GenCryptoContext(params, seed=seed, device=device)
    cc.Enable(PKESchemeFeature.PKE)
    cc.Enable(PKESchemeFeature.KEYSWITCH)
    cc.Enable(PKESchemeFeature.LEVELEDSHE)
    print(f"CKKS ring dimension: {cc.GetRingDimension()}")

    keys = cc.KeyGen()
    cc.EvalMultKeyGen(keys.secret_key)
    cc.EvalRotateKeyGen(keys.secret_key, [1, -2])

    x1 = np.array([0.25, 0.5, 0.75, 1.0, 2.0, 3.0, 4.0, 5.0])
    x2 = np.array([5.0, 4.0, 3.0, 2.0, 1.0, 0.75, 0.5, 0.25])
    c1 = cc.Encrypt(keys.public_key, cc.MakeCKKSPackedPlaintext(x1))
    c2 = cc.Encrypt(keys.public_key, cc.MakeCKKSPackedPlaintext(x2))

    ops = [("x1+x2", cc.EvalAdd(c1, c2), x1 + x2),
           ("x1-x2", cc.EvalSub(c1, c2), x1 - x2),
           ("4*x1", cc.EvalMult(c1, 4.0), 4 * x1),
           ("x1*x2", cc.EvalMult(c1, c2), x1 * x2),
           ("rot(x1,1)", cc.EvalRotate(c1, 1), np.roll(x1, -1)),
           ("rot(x1,-2)", cc.EvalRotate(c1, -2), np.roll(x1, 2))]
    out = {}
    for name, ct, want in ops:
        got = np.asarray(cc.Decrypt(keys.secret_key, ct).values).real[:8]
        print(f"{name:>10}: {np.round(got, 4)}  (max err "
              f"{np.abs(got - want).max():.2e})")
        out[name] = (got, want)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
