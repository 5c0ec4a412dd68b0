"""CKKS bootstrapping with FFT-factorized transforms on the port.

Counterpart of `examples/advanced_ckks_bootstrapping.py` (reference:
src/pke/examples/advanced-ckks-bootstrapping.cpp, scaled down): sparse
packing with level budget (2, 2). On the GPU unless `--device cpu`:

    python examples_torch/advanced_ckks_bootstrapping.py [--device cpu]
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

TOL = 0.1


def main(device=None, ring_dim=256, mult_depth=20, scaling_mod_size=28,
         first_mod_size=30, security_level=SecurityLevel.HEStd_NotSet,
         seed=11, slots=8, level_budget=(2, 2)) -> dict:
    """EvalBootstrap of a fresh encryption; returns the decryption beside
    the input and the tower counts before and after."""
    params = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                      mult_depth=mult_depth,
                      scaling_mod_size=scaling_mod_size,
                      first_mod_size=first_mod_size,
                      security_level=security_level,
                      scaling_technique=ScalingTechnique.FLEXIBLEAUTO)
    cc = GenCryptoContext(params, seed=seed, device=device)
    for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
              PKESchemeFeature.LEVELEDSHE, PKESchemeFeature.ADVANCEDSHE,
              PKESchemeFeature.FHE):
        cc.Enable(f)

    print(f"CKKS bootstrapping, N={cc.ring_dim}, slots={slots}, "
          f"level budget {level_budget} (FFT-factorized C2S/S2C)")
    cc.EvalBootstrapSetup(level_budget=level_budget, slots=slots)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)
    cc.EvalBootstrapKeyGen(kp.secret_key, slots)

    x = np.array([0.25, 0.5, 0.75, 1.0, 2.0, 3.0, 4.0, 5.0]) / 5.0
    ct = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(x, slots=slots))
    before = cc.size_ql(ct.level)
    print(f"towers before bootstrap: {before} (depleted input would have 2)")
    refreshed = cc.EvalBootstrap(ct)
    after = cc.size_ql(refreshed.level)
    print(f"towers after bootstrap:  {after}")

    got = np.asarray(cc.Decrypt(kp.secret_key, refreshed).values).real
    got = got[:slots]
    err = np.abs(got - x).max()
    print(f"input : {np.round(x, 4)}")
    print(f"output: {np.round(got, 4)}")
    print(f"max error: {err:.2e}")
    assert err < TOL
    print("OK")
    return {"checks": {"bootstrapped": close(got, x, TOL)},
            "towers": (before, after)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
