"""Two-round CKKS bootstrapping, composite scaling, full packing (port).

Counterpart of
`examples/iterative_ckks_bootstrapping_composite_scaling.py` (reference:
src/pke/examples/iterative-ckks-bootstrapping-composite-scaling.cpp): ring
dimension 128 with every slot used (64), COMPOSITESCALINGAUTO with 61-bit
scales from three 27-bit word primes, level budget (3, 3), one round and
two. On the GPU unless `--device cpu`:

    python examples_torch/iterative_ckks_bootstrapping_composite_scaling.py \
        [--device cpu]
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

GAIN_BITS = 2.0


def main(device=None, ring_dim=128, mult_depth=24, scaling_mod_size=61,
         first_mod_size=66, composite_degree=3, register_word_size=27,
         security_level=SecurityLevel.HEStd_NotSet, seed=11, data_seed=42,
         level_budget=(3, 3), level=22) -> dict:
    """Both rounds' precisions (bits of the mean error); the check holds
    the second round's gain above GAIN_BITS, as the JAX example does."""
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

    slots = cc.ring_dim // 2            # full packing (reference M/4)
    cc.EvalBootstrapSetup(level_budget=level_budget, slots=slots)
    keys = cc.KeyGen()
    cc.EvalMultKeyGen(keys.secret_key)
    cc.EvalBootstrapKeyGen(keys.secret_key, slots)

    rng = np.random.default_rng(data_seed)
    x = rng.uniform(-1, 1, slots)
    ct = cc.Encrypt(keys.public_key,
                    cc.MakeCKKSPackedPlaintext(x, slots=slots))
    ct = cc.LevelReduce(ct, level)       # deplete the level budget first

    def dec(c):
        return np.asarray(cc.Decrypt(keys.secret_key, c).values).real[:slots]

    r1 = dec(cc.EvalBootstrap(ct))
    prec1 = float(abs(np.log2(np.abs(r1 - x).mean())))
    r2 = dec(cc.EvalBootstrap(ct, num_iterations=2,
                              precision=int(np.floor(prec1))))
    prec2 = float(abs(np.log2(np.abs(r2 - x).mean())))
    print(f"Bootstrapping precision after 1 iteration:  {prec1:.1f} bits")
    print(f"Bootstrapping precision after 2 iterations: {prec2:.1f} bits")
    assert prec2 > prec1 + GAIN_BITS, \
        "iterative bootstrap should gain precision"
    print("OK")
    return {"checks": {"gain": exact(prec2 > prec1 + GAIN_BITS, True)},
            "precision_bits": (prec1, prec2)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
