"""Polynomial evaluation on the port (CKKS): linear and Paterson-Stockmeyer.

Counterpart of `examples/polynomial_evaluation.py` (reference:
src/pke/examples/polynomial-evaluation.cpp), on the GPU unless
`--device cpu`:

    python examples_torch/polynomial_evaluation.py [--device cpu]
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

TOL = 1e-2


def main(device=None, ring_dim=512, mult_depth=10, scaling_mod_size=28,
         first_mod_size=30, security_level=SecurityLevel.HEStd_NotSet,
         seed=1) -> dict:
    """EvalPoly of a degree-4 and a degree-12 polynomial; returns each
    decryption beside what it should be."""
    p = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                 mult_depth=mult_depth, scaling_mod_size=scaling_mod_size,
                 first_mod_size=first_mod_size, batch_size=8,
                 security_level=security_level,
                 scaling_technique=ScalingTechnique.FLEXIBLEAUTO)
    cc = GenCryptoContext(p, seed=seed, device=device)
    cc.Enable(PKESchemeFeature.PKE | PKESchemeFeature.KEYSWITCH
              | PKESchemeFeature.LEVELEDSHE | PKESchemeFeature.ADVANCEDSHE)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)

    x = np.array([0.5, 0.7, 0.9, 0.95, 0.93, 0.2, -0.4, -0.9])
    ct = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(x, slots=8))
    checks = {}
    # low degree -> EvalPolyLinear; higher degree -> Paterson-Stockmeyer
    for label, coeffs in (
            ("f1(x)", [0.15, 0.75, 0.0, 1.25, 1.0]),
            ("f2(x)", [1, 0.5, 0.25, 0.125, 0.0625, 0.03, 0.01, 0.005,
                       0.002, 0.001, 0.0005, 0.0002, 0.0001])):
        got = np.asarray(cc.Decrypt(kp.secret_key,
                                    cc.EvalPoly(ct, coeffs)).values).real[:8]
        want = np.polyval(list(reversed(coeffs)), x)
        print(f"{label}     =", np.round(got, 5))
        print("expected  =", np.round(want, 5))
        assert np.abs(got - want).max() < TOL
        checks[label] = close(got, want, TOL)
    print("polynomial evaluation OK")
    return {"checks": checks}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
