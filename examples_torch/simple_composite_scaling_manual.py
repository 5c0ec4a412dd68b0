"""CKKS at a 95-bit scale on the port: composite degree 4, set by hand.

Counterpart of `examples/simple_composite_scaling_manual.py` (reference:
src/pke/examples/simple-composite-scaling-manual.cpp):
COMPOSITESCALINGMANUAL with composite degree 4 and register word size 27,
the basic operations checked to 1e-8. On the GPU unless `--device cpu`:

    python examples_torch/simple_composite_scaling_manual.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from examples_torch import close  # noqa: E402
from openfhe_tpu_torch import (CCParams, GenCryptoContext,  # noqa: E402
                               PKESchemeFeature, ScalingTechnique, Scheme,
                               SecurityLevel)

TOL = 1e-8


def main(device=None, ring_dim=1 << 9, mult_depth=2, first_mod_size=96,
         scaling_mod_size=95, composite_degree=4, register_word_size=27,
         security_level=SecurityLevel.HEStd_NotSet, seed=5) -> dict:
    """Add, subtract, scalar and ciphertext products, rotations and
    scalar adds; returns each decryption beside what it should be."""
    params = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                      mult_depth=mult_depth, first_mod_size=first_mod_size,
                      scaling_mod_size=scaling_mod_size,
                      composite_degree=composite_degree,
                      register_word_size=register_word_size, batch_size=8,
                      security_level=security_level,
                      scaling_technique=(
                          ScalingTechnique.COMPOSITESCALINGMANUAL))
    cc = GenCryptoContext(params, seed=seed, device=device)
    print(f"CKKS scheme is using ring dimension {cc.ring_dim}")
    print(f"composite degree d = {cc.comp_deg}, "
          f"register word size = {params.register_word_size}\n")

    cc.Enable(PKESchemeFeature.PKE | PKESchemeFeature.KEYSWITCH
              | PKESchemeFeature.LEVELEDSHE)
    keys = cc.KeyGen()
    cc.EvalMultKeyGen(keys.secret_key)
    cc.EvalRotateKeyGen(keys.secret_key, [1, -2])

    x1 = np.array([0.25, 0.5, 0.75, 1.0, 2.0, 3.0, 4.0, 5.0])
    x2 = np.array([5.0, 4.0, 3.0, 2.0, 1.0, 0.75, 0.5, 0.25])
    c1 = cc.Encrypt(keys.public_key, cc.MakeCKKSPackedPlaintext(x1, slots=8))
    c2 = cc.Encrypt(keys.public_key, cc.MakeCKKSPackedPlaintext(x2, slots=8))

    cases = (("x1 + x2", cc.EvalAdd(c1, c2), x1 + x2, 0, 8),
             ("x1 - x2", cc.EvalSub(c1, c2), x1 - x2, 0, 8),
             ("4 * x1", cc.EvalMult(c1, 4.0), 4 * x1, 0, 8),
             # MANUAL: rescale by hand
             ("x1 * x2", cc.Rescale(cc.EvalMult(c1, c2)), x1 * x2, 0, 8),
             ("x1 rot(1)", cc.EvalRotate(c1, 1), x1[1:], 0, 7),
             ("x1 rot(-2)", cc.EvalRotate(c1, -2), x1[:6], 2, 8),
             ("x1 - 0.5", cc.EvalSub(c1, 0.5), x1 - 0.5, 0, 8),
             ("x1 + (-0.5)", cc.EvalAdd(c1, -0.5), x1 - 0.5, 0, 8))
    print("Results of homomorphic computations:")
    checks = {}
    for label, ct, want, lo, hi in cases:
        got = np.asarray(cc.Decrypt(keys.secret_key, ct).values).real[lo:hi]
        err = np.abs(got - want).max()
        print(f"{label}: {np.round(got, 8)}   (max err {err:.2e})")
        assert err < TOL
        checks[label] = close(got, want, TOL)
    print("\nsimple-composite-scaling-manual: all checks passed")
    return {"checks": checks}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
