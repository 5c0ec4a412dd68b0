"""Smooth functions by Chebyshev interpolation on the port (CKKS).

Counterpart of `examples/function_evaluation.py` (reference:
src/pke/examples/function-evaluation.cpp), on the GPU unless
`--device cpu`:

    python examples_torch/function_evaluation.py [--device cpu]
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

TOL = 1e-3      # the JAX example asserts none


def main(device=None, ring_dim=512, mult_depth=10, scaling_mod_size=28,
         first_mod_size=30, security_level=SecurityLevel.HEStd_NotSet,
         seed=0, degree=32) -> dict:
    """EvalLogistic and EvalSin over [-1, 1] at degree 32; returns each
    decryption beside what it should be."""
    params = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                      mult_depth=mult_depth,
                      scaling_mod_size=scaling_mod_size,
                      first_mod_size=first_mod_size, batch_size=8,
                      security_level=security_level,
                      scaling_technique=ScalingTechnique.FLEXIBLEAUTO)
    cc = GenCryptoContext(params, seed=seed, device=device)
    for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
              PKESchemeFeature.LEVELEDSHE, PKESchemeFeature.ADVANCEDSHE):
        cc.Enable(f)
    keys = cc.KeyGen()
    cc.EvalMultKeyGen(keys.secret_key)

    x = np.array([-0.9, -0.6, -0.3, 0.0, 0.3, 0.6, 0.9, 0.95])
    ct = cc.Encrypt(keys.public_key, cc.MakeCKKSPackedPlaintext(x, slots=8))
    checks = {}
    for label, res, want in (
            ("logistic", cc.EvalLogistic(ct, -1, 1, degree),
             1 / (1 + np.exp(-x))),
            ("sin", cc.EvalSin(ct, -1, 1, degree), np.sin(x))):
        got = np.asarray(cc.Decrypt(keys.secret_key, res).values).real[:8]
        print(f"{label:8s}:", np.round(got, 5), "max err:",
              f"{np.abs(got - want).max():.2e}")
        checks[label] = close(got, want, TOL)
    return {"checks": checks}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
