"""CKKS bootstrapping on the port: refresh a depleted ciphertext.

Counterpart of `examples/simple_ckks_bootstrapping.py` (reference:
src/pke/examples/simple-ckks-bootstrapping.cpp), on the GPU unless
`--device cpu`:

    python examples_torch/simple_ckks_bootstrapping.py [--device cpu]
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

# the JAX example asserts none; a bootstrap at 28-bit scales keeps about 6
# to 8 bits (the JAX package's own run of this example: max error 1.4e-2),
# and tests/test_bootstrap.py holds such a round trip to 4 bits
TOL = 2.0 ** -4


def main(device=None, ring_dim=256, mult_depth=18, scaling_mod_size=28,
         first_mod_size=30, security_level=SecurityLevel.HEStd_NotSet,
         seed=0, slots=8) -> dict:
    """EvalBootstrap of an input left with 3 towers; returns the
    decryption beside the input and the tower counts before and after."""
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

    cc.EvalBootstrapSetup(slots=slots)
    keys = cc.KeyGen()
    cc.EvalMultKeyGen(keys.secret_key)
    cc.EvalBootstrapKeyGen(keys.secret_key, slots)

    x = np.array([0.25, 0.5, -0.75, 0.1, -0.3, 0.8, -0.2, 0.6])
    ct = cc.Encrypt(keys.public_key,
                    cc.MakeCKKSPackedPlaintext(x, slots=slots))
    ct = cc.LevelReduce(ct, cc.size_ql(0) - 3)    # deplete the level budget
    before = cc.size_ql(ct.level)
    print("towers before bootstrap:", before)
    ct = cc.EvalBootstrap(ct)
    after = cc.size_ql(ct.level)
    print("towers after bootstrap :", after)
    got = np.asarray(cc.Decrypt(keys.secret_key, ct).values).real[:slots]
    print("decrypted:", np.round(got, 3))
    print("expected :", x)
    return {"checks": {"bootstrapped": close(got, x, TOL)},
            "towers": (before, after)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
