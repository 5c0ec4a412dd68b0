"""CKKS bootstrapping under composite scaling on the port.

Counterpart of `examples/simple_ckks_bootstrapping_composite_scaling.py`
(reference: src/pke/examples/
simple-ckks-bootstrapping-composite-scaling.cpp): COMPOSITESCALINGAUTO
with 59-bit scales from three 27-bit word primes, 8 slots, level budget
(3, 3); the input is depleted to its last level and bootstrapped. On the
GPU unless `--device cpu`:

    python examples_torch/simple_ckks_bootstrapping_composite_scaling.py \
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

TOL = 1e-2


def main(device=None, ring_dim=256, mult_depth=20, scaling_mod_size=59,
         first_mod_size=64, composite_degree=3, register_word_size=27,
         security_level=SecurityLevel.HEStd_NotSet, seed=7, slots=8,
         level_budget=(3, 3)) -> dict:
    """The bootstrapped decryption beside the input, its precision in
    bits and the levels left before and after."""
    params = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                      mult_depth=mult_depth,
                      scaling_mod_size=scaling_mod_size,
                      first_mod_size=first_mod_size,
                      composite_degree=composite_degree,
                      register_word_size=register_word_size,
                      security_level=security_level,
                      scaling_technique=ScalingTechnique.COMPOSITESCALINGAUTO)
    cc = GenCryptoContext(params, seed=seed, device=device)
    for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
              PKESchemeFeature.LEVELEDSHE, PKESchemeFeature.ADVANCEDSHE,
              PKESchemeFeature.FHE):
        cc.Enable(f)
    print(f"CKKS scheme is using ring dimension {cc.ring_dim}")
    print(f"compositeDegree={cc.comp_deg} "
          f"modBitWidth={scaling_mod_size / cc.comp_deg:.2f} "
          f"targetHWArchWordSize={register_word_size}\n")

    cc.EvalBootstrapSetup(level_budget=level_budget, slots=slots)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)
    cc.EvalBootstrapKeyGen(kp.secret_key, slots)

    x = np.array([0.25, 0.5, 0.75, 1.0, 2.0, 3.0, 4.0, 5.0]) / 5.0
    ct = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(x, slots=slots))
    ct = cc.LevelReduce(ct, cc.params.mult_depth - 1)   # deplete the budget
    before = cc.params.mult_depth - ct.level
    print(f"Initial number of levels remaining: {before}")

    ct_boot = cc.EvalBootstrap(ct)
    after = cc.params.mult_depth - ct_boot.level
    print(f"Number of levels remaining after bootstrapping: {after}")

    got = np.asarray(cc.Decrypt(kp.secret_key, ct_boot).values).real[:slots]
    err = np.abs(got - x).max()
    prec = -np.log2(err) if err > 0 else 40.0
    print(f"Output after bootstrapping: {np.round(got, 6)}")
    print(f"max err {err:.3e} (~{prec:.1f} bits precision)")
    assert err < TOL
    print("OK")
    return {"checks": {"bootstrapped": close(got, x, TOL)},
            "precision_bits": prec, "levels": (before, after)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
