"""Two-party interactive CKKS bootstrapping on the port.

Counterpart of `examples/interactive_bootstrapping.py` (reference:
src/pke/examples/interactive-bootstrapping.cpp): a server and a client
holding shares of a joint key refresh a ciphertext reduced to its last
levels; a threshold decryption checks it. On the GPU unless
`--device cpu`:

    python examples_torch/interactive_bootstrapping.py [--device cpu]
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


def main(device=None, ring_dim=512, mult_depth=8, scaling_mod_size=28,
         first_mod_size=30, security_level=SecurityLevel.HEStd_NotSet,
         seed=0, level=5) -> dict:
    """The refreshed ciphertext's threshold decryption beside the input,
    and the tower counts before and after."""
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

    kp1 = cc.MultipartyKeyGen()                 # the server
    kp2 = cc.MultipartyKeyGen(kp1.public_key)   # the client
    joint_pk = kp2.public_key

    x = np.array([0.25, -0.5, 0.75, 0.1, -0.3, 0.8, -0.2, 0.6])
    ct = cc.Encrypt(joint_pk, cc.MakeCKKSPackedPlaintext(x, slots=8))
    ct = cc.LevelReduce(ct, level)
    before = cc.size_ql(ct.level)
    print("towers before:", before)

    ct_adj = cc.IntBootAdjustScale(ct)
    share_server = cc.IntBootDecrypt(kp1.secret_key, ct_adj)
    c1_only = ct_adj.replace(elements=(ct_adj.elements[1],))
    share_client = cc.IntBootDecrypt(kp2.secret_key, c1_only)
    share_client = cc.IntBootEncrypt(joint_pk, share_client)
    refreshed = cc.IntBootAdd(share_client, share_server)
    after = cc.size_ql(refreshed.level)
    print("towers after :", after)

    p1 = cc.MultipartyDecryptLead([refreshed], kp1.secret_key)
    p2 = cc.MultipartyDecryptMain([refreshed], kp2.secret_key)
    res = cc.MultipartyDecryptFusion([p1[0], p2[0]], refreshed)
    got = np.asarray(res.values).real[:8]
    print("decrypted:", np.round(got, 4))
    print("expected :", x)
    return {"checks": {"refreshed": close(got, x, TOL)},
            "towers": (before, after)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
