"""Threshold CKKS with a two-party interactive bootstrap on the port.

Counterpart of `examples/tckks_interactive_mp_bootstrapping.py`
(reference: src/pke/examples/tckks-interactive-mp-bootstrapping.cpp): two
parties refresh a depleted joint-key ciphertext without either seeing
the plaintext, then evaluate a logistic function on it under a joint
relinearization key. On the GPU unless `--device cpu`:

    python examples_torch/tckks_interactive_mp_bootstrapping.py \
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

REFRESH_TOL = 1e-2
LOGISTIC_TOL = 5e-2


def main(device=None, ring_dim=256, mult_depth=7, scaling_mod_size=28,
         first_mod_size=30, security_level=SecurityLevel.HEStd_NotSet,
         seed=13, level=4) -> dict:
    """The refreshed ciphertext and its logistic, each threshold-decrypted,
    beside what they should be, and the tower counts before and after."""
    params = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                      mult_depth=mult_depth,
                      scaling_mod_size=scaling_mod_size,
                      first_mod_size=first_mod_size, batch_size=8,
                      security_level=security_level,
                      scaling_technique=ScalingTechnique.FLEXIBLEAUTO)
    cc = GenCryptoContext(params, seed=seed, device=device)
    for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
              PKESchemeFeature.LEVELEDSHE, PKESchemeFeature.ADVANCEDSHE,
              PKESchemeFeature.MULTIPARTY):
        cc.Enable(f)

    # the joint key: party 1 then party 2 (round-robin)
    kp1 = cc.MultipartyKeyGen()
    kp2 = cc.MultipartyKeyGen(kp1.public_key)
    joint_pk = kp2.public_key
    tag = joint_pk.key_tag

    # the joint relinearization key (the two-round protocol), needed for
    # the Chebyshev evaluation after the refresh
    ek1 = cc.KeySwitchGen(kp1.secret_key, kp1.secret_key)
    ek2 = cc.MultiKeySwitchGen(kp2.secret_key, kp2.secret_key, ek1)
    ek12 = cc.MultiAddEvalKeys(ek1, ek2, tag)
    ek1m = cc.MultiMultEvalKey(ek12, kp1.secret_key, tag)
    ek2m = cc.MultiMultEvalKey(ek12, kp2.secret_key, tag)
    cc.InsertEvalMultKey(cc.MultiAddEvalMultKeys(ek1m, ek2m, tag), tag)

    x = np.array([0.12, -0.24, 0.36, -0.48, 0.5, -0.6, 0.7, -0.8])
    ct = cc.Encrypt(joint_pk, cc.MakeCKKSPackedPlaintext(x, slots=8))
    ct = cc.LevelReduce(ct, level)                   # deplete the budget
    before = cc.size_ql(ct.level)
    print("towers before interactive bootstrap:", before)

    # adjust; party 1 (lead) shares c0 + c1 s, party 2 c1 s; then encrypt
    ct_adj = cc.IntMPBootAdjustScale(ct)
    a = cc.IntMPBootRandomElementGen(joint_pk)
    c1_only = ct_adj.replace(elements=(ct_adj.elements[1],))
    share1 = cc.IntMPBootDecrypt(kp1.secret_key, ct_adj, a)
    share2 = cc.IntMPBootDecrypt(kp2.secret_key, c1_only, a)
    shares = cc.IntMPBootAdd([share1, share2])
    fresh = cc.IntMPBootEncrypt(joint_pk, shares, a, ct_adj)
    after = cc.size_ql(fresh.level)
    print("towers after  interactive bootstrap:", after)
    assert after > before

    def joint_decrypt(c):
        lead = cc.MultipartyDecryptLead([c], kp1.secret_key)[0]
        main_ = cc.MultipartyDecryptMain([c], kp2.secret_key)[0]
        return np.asarray(
            cc.MultipartyDecryptFusion([lead, main_], c).values).real[:8]

    got = joint_decrypt(fresh)
    print("refreshed decrypt err:", np.abs(got - x).max())
    assert np.abs(got - x).max() < REFRESH_TOL
    checks = {"refreshed": close(got, x, REFRESH_TOL)}

    # the Chebyshev variant: logistic(x) on the refreshed ciphertext
    got = joint_decrypt(cc.EvalLogistic(fresh, -1.0, 1.0, 8))
    want = 1.0 / (1.0 + np.exp(-x))
    print("logistic after refresh err:", np.abs(got - want).max())
    assert np.abs(got - want).max() < LOGISTIC_TOL
    checks["logistic"] = close(got, want, LOGISTIC_TOL)
    print("OK")
    return {"checks": checks, "towers": (before, after)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
