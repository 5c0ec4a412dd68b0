"""High-precision EvalPoly on the port at composite degree 3.

Counterpart of
`examples/polynomial_evaluation_high_precision_composite_scaling.py`
(reference: src/pke/examples/
polynomial-evaluation-high-precision-composite-scaling.cpp, its d = 3
block; the first modulus is 90 bits, as the moduli stay below 2^31), with
each evaluation timed. On the GPU unless `--device cpu`:

    python examples_torch/polynomial_evaluation_high_precision_composite_scaling.py \
        [--device cpu]
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
from openfhe_tpu_torch.utils.profiling import TIC, TOC_MS  # noqa: E402

TOL = 1e-8
COEFFS1 = [0.15, 0.75, 0, 1.25, 0, 0, 1, 0, 1, 2, 0, 1, 0, 0, 0, 0, 1]
COEFFS2 = [1, 2, 3, 4, 5, -1, -2, -3, -4, -5,
           0.1, 0.2, 0.3, 0.4, 0.5, -0.1, -0.2, -0.3, -0.4, -0.5,
           0.1, 0.2, 0.3, 0.4, 0.5, -0.1, -0.2, -0.3, -0.4, -0.5]


def main(device=None, ring_dim=1 << 9, mult_depth=6, first_mod_size=90,
         scaling_mod_size=80, composite_degree=3, register_word_size=32,
         security_level=SecurityLevel.HEStd_NotSet, seed=9) -> dict:
    """EvalPoly of a degree-16 and a degree-29 polynomial; returns each
    decryption beside what it should be and each evaluation's ms."""
    print("\n======EXAMPLE FOR EVALPOLY========\n")
    params = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                      mult_depth=mult_depth, first_mod_size=first_mod_size,
                      scaling_mod_size=scaling_mod_size,
                      composite_degree=composite_degree,
                      register_word_size=register_word_size, batch_size=8,
                      security_level=security_level,
                      scaling_technique=ScalingTechnique.COMPOSITESCALINGAUTO)
    cc = GenCryptoContext(params, seed=seed, device=device)
    cc.Enable(PKESchemeFeature.PKE | PKESchemeFeature.KEYSWITCH
              | PKESchemeFeature.LEVELEDSHE | PKESchemeFeature.ADVANCEDSHE)

    x = np.array([0.5, 0.7, 0.9, 0.95, 0.93])
    keys = cc.KeyGen()
    cc.EvalMultKeyGen(keys.secret_key)
    ct = cc.Encrypt(keys.public_key, cc.MakeCKKSPackedPlaintext(x, slots=8))

    out = {"checks": {}, "ms": {}}
    for label, coeffs in (("poly1", COEFFS1), ("poly2", COEFFS2)):
        t = TIC()
        res = cc.EvalPoly(ct, coeffs)
        ms = TOC_MS(t, res)
        want = np.polyval(list(reversed(coeffs)), x)
        got = np.asarray(cc.Decrypt(keys.secret_key, res).values).real[:5]
        err = np.abs(got - want).max()
        print("Result of evaluating a polynomial with coefficients", coeffs)
        print("  ", np.round(got, 10))
        print("   expected:", np.round(want, 10))
        print(f"   Evaluation time: {ms:.2f} ms, max err {err:.2e}")
        assert err < TOL
        out["checks"][label] = close(got, want, TOL)
        out["ms"][label] = ms
    print("\nhigh-precision EvalPoly passed")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
