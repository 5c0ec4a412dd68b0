"""Threshold CKKS on the port: joint keys, shared evaluation, joint decrypt.

Counterpart of `examples/threshold_fhe.py` (reference:
src/pke/examples/threshold-fhe.cpp): three parties' round-robin key
generation, an encryption under the joint key, and a decryption that
needs every party's share. On the GPU unless `--device cpu`:

    python examples_torch/threshold_fhe.py [--device cpu]
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


def main(device=None, ring_dim=512, mult_depth=3, scaling_mod_size=28,
         first_mod_size=30, security_level=SecurityLevel.HEStd_NotSet,
         seed=0) -> dict:
    """2 x through the joint key and the three-party decryption; returns
    it beside what it should be. `ring_dim=0` lets the security tables
    choose N."""
    params = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                      mult_depth=mult_depth,
                      scaling_mod_size=scaling_mod_size,
                      first_mod_size=first_mod_size, batch_size=8,
                      security_level=security_level,
                      scaling_technique=ScalingTechnique.FLEXIBLEAUTO)
    cc = GenCryptoContext(params, seed=seed, device=device)
    for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
              PKESchemeFeature.LEVELEDSHE, PKESchemeFeature.MULTIPARTY):
        cc.Enable(f)
    print(f"CKKS ring dimension {cc.GetRingDimension()}")

    # round-robin joint key generation across three parties
    kp1 = cc.MultipartyKeyGen()
    kp2 = cc.MultipartyKeyGen(kp1.public_key)
    kp3 = cc.MultipartyKeyGen(kp2.public_key)
    joint_pk = kp3.public_key

    x = np.array([0.5, -1.0, 2.0, 0.25, 1.5, -0.5, 0.75, -2.0])
    ct = cc.Encrypt(joint_pk, cc.MakeCKKSPackedPlaintext(x, slots=8))
    ct = cc.EvalAdd(ct, ct)

    # the distributed decryption: lead and mains, then the fusion
    p1 = cc.MultipartyDecryptLead([ct], kp1.secret_key)
    p2 = cc.MultipartyDecryptMain([ct], kp2.secret_key)
    p3 = cc.MultipartyDecryptMain([ct], kp3.secret_key)
    res = cc.MultipartyDecryptFusion([p1[0], p2[0], p3[0]], ct)
    got = np.asarray(res.values).real[:8]
    print("2*x:", np.round(got, 4))
    print("err:", np.abs(got - 2 * x).max())
    return {"checks": {"2x": close(got, 2 * x, TOL)},
            "ring_dim": cc.GetRingDimension()}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
