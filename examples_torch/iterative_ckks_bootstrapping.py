"""Two-round (Meta-BTS) CKKS bootstrapping on the port.

Counterpart of `examples/iterative_ckks_bootstrapping.py` (reference:
src/pke/examples/iterative-ckks-bootstrapping.cpp): one EvalBootstrap,
then two rounds fed the first round's precision, at composite 50-bit
scales. Both precisions are printed and returned. The JAX example also
asserts that the second round gains more than 2 bits; at this context
(N = 256) that holds in neither package (ROADMAP queue 3, faults in the
reference), so this example asserts only what holds in both: each
precision at least MIN_BITS. On the GPU unless `--device cpu`:

    python examples_torch/iterative_ckks_bootstrapping.py [--device cpu]
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

MIN_BITS = 8.0


def main(device=None, ring_dim=256, mult_depth=24, scaling_mod_size=50,
         first_mod_size=56, security_level=SecurityLevel.HEStd_NotSet,
         seed=2, slots=8, level=22) -> dict:
    """One round and two; returns both decryptions beside the input and
    both precisions in bits."""
    params = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                      mult_depth=mult_depth,
                      scaling_mod_size=scaling_mod_size,
                      first_mod_size=first_mod_size, batch_size=slots,
                      security_level=security_level,
                      scaling_technique=ScalingTechnique.COMPOSITESCALINGAUTO)
    cc = GenCryptoContext(params, seed=seed, device=device)
    for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
              PKESchemeFeature.LEVELEDSHE, PKESchemeFeature.ADVANCEDSHE,
              PKESchemeFeature.FHE):
        cc.Enable(f)

    cc.EvalBootstrapSetup(slots=slots)
    keys = cc.KeyGen()
    cc.EvalMultKeyGen(keys.secret_key)
    cc.EvalBootstrapKeyGen(keys.secret_key, slots)

    x = np.array([0.111111, 0.222222, 0.333333, 0.444444,
                  0.555555, 0.666666, 0.777777, 0.888888])
    ct = cc.Encrypt(keys.public_key,
                    cc.MakeCKKSPackedPlaintext(x, slots=slots))
    ct = cc.LevelReduce(ct, level)       # deplete the level budget first

    def dec(c):
        return np.asarray(cc.Decrypt(keys.secret_key, c).values).real[:slots]

    got1 = dec(cc.EvalBootstrap(ct))                    # one round
    prec1 = float(-np.log2(np.abs(got1 - x).max()))
    got2 = dec(cc.EvalBootstrap(ct, num_iterations=2,
                                precision=int(np.floor(prec1))))
    prec2 = float(-np.log2(np.abs(got2 - x).max()))
    print(f"single-pass precision: {prec1:.1f} bits")
    print(f"two-round  precision: {prec2:.1f} bits")
    assert prec1 >= MIN_BITS and prec2 >= MIN_BITS
    print("OK")
    tol = 2.0 ** -MIN_BITS
    return {"checks": {"one round": close(got1, x, tol),
                       "two rounds": close(got2, x, tol)},
            "precision_bits": (prec1, prec2)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
