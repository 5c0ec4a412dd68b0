"""CKKS with composite scaling on the port: 50-bit scales from word pairs.

Counterpart of `examples/simple_real_numbers_composite_scaling.py`
(reference: src/pke/examples/simple-real-numbers-composite-scaling.cpp),
on the GPU unless `--device cpu`:

    python examples_torch/simple_real_numbers_composite_scaling.py \
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

TOL = 1e-8      # far beyond one 28-bit scale's precision


def main(device=None, ring_dim=256, mult_depth=4, scaling_mod_size=50,
         first_mod_size=56, security_level=SecurityLevel.HEStd_NotSet,
         seed=9) -> dict:
    """x^3 + x under COMPOSITESCALINGAUTO and COMPOSITESCALINGMANUAL;
    returns each decryption beside what it should be."""
    checks = {}
    for tech in (ScalingTechnique.COMPOSITESCALINGAUTO,
                 ScalingTechnique.COMPOSITESCALINGMANUAL):
        params = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                          mult_depth=mult_depth,
                          scaling_mod_size=scaling_mod_size,
                          first_mod_size=first_mod_size, batch_size=8,
                          security_level=security_level,
                          scaling_technique=tech)
        cc = GenCryptoContext(params, seed=seed, device=device)
        print(f"{tech.name}: composite degree {cc.comp_deg}")
        for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
                  PKESchemeFeature.LEVELEDSHE):
            cc.Enable(f)
        keys = cc.KeyGen()
        cc.EvalMultKeyGen(keys.secret_key)
        x = np.array([0.25, 0.5, 0.75, 1.0, 2.0, 3.0, 4.0, 5.0])
        ct = cc.Encrypt(keys.public_key,
                        cc.MakeCKKSPackedPlaintext(x, slots=8))
        c2 = cc.EvalMult(ct, ct)
        if tech == ScalingTechnique.COMPOSITESCALINGMANUAL:
            c2 = cc.Rescale(c2)
        c3 = cc.EvalAdd(cc.EvalMult(c2, ct), ct)
        got = np.asarray(cc.Decrypt(keys.secret_key, c3).values).real[:8]
        want = x ** 3 + x
        err = np.abs(got - want).max()
        print(f"  x^3+x max err {err:.2e} (~{-np.log2(err):.0f} bits)")
        assert err < TOL
        checks[tech.name] = close(got, want, TOL)
    print("OK")
    return {"checks": checks}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
