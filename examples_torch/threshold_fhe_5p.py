"""Five-party threshold BGV on the port: joint keys and a joint decryption.

Counterpart of `examples/threshold_fhe_5p.py` (reference:
src/pke/examples/threshold-fhe-5p.cpp; all parties in one process), on
the GPU unless `--device cpu`:

    python examples_torch/threshold_fhe_5p.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from examples_torch import exact  # noqa: E402
from openfhe_tpu_torch import (CCParams, GenCryptoContext,  # noqa: E402
                               PKESchemeFeature, Scheme, SecurityLevel)


def main(device=None, num_parties=5, ring_dim=1024, mult_depth=2,
         plaintext_modulus=65537, security_level=SecurityLevel.HEStd_NotSet,
         seed=8) -> dict:
    """x + y under the five parties' joint key; returns the joint
    decryption beside what it should be."""
    p = CCParams(scheme=Scheme.BGVRNS_SCHEME, ring_dim=ring_dim,
                 mult_depth=mult_depth, plaintext_modulus=plaintext_modulus,
                 batch_size=8, security_level=security_level)
    cc = GenCryptoContext(p, seed=seed, device=device)
    cc.Enable(PKESchemeFeature.PKE | PKESchemeFeature.KEYSWITCH
              | PKESchemeFeature.LEVELEDSHE | PKESchemeFeature.MULTIPARTY)

    # round-robin joint key generation across the parties
    kps = [cc.MultipartyKeyGen()]
    for _ in range(num_parties - 1):
        kps.append(cc.MultipartyKeyGen(kps[-1].public_key))
    joint_pk = kps[-1].public_key

    x = np.array([1, 2, 3, 4, 5, 6, 7, 8])
    y = np.array([2, 2, 2, 2, 2, 2, 2, 2])
    cx = cc.Encrypt(joint_pk, cc.MakePackedPlaintext(x))
    cy = cc.Encrypt(joint_pk, cc.MakePackedPlaintext(y))
    res = cc.EvalAdd(cx, cy)

    # the distributed decryption: lead and main shares, then the fusion
    partials = [cc.MultipartyDecryptLead([res], kps[0].secret_key)[0]]
    for kp in kps[1:]:
        partials.append(cc.MultipartyDecryptMain([res], kp.secret_key)[0])
    got = np.asarray(cc.MultipartyDecryptFusion(partials, res).values[:8])
    print(f"{num_parties}-party decrypt:", got)
    assert np.array_equal(got, x + y)
    print("threshold 5-party OK")
    return {"checks": {"x+y": exact(got, x + y)}}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
