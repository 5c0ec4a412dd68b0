"""Three-party interactive bootstrap and a Chebyshev series on the port.

Counterpart of `examples/tckks_interactive_mp_bootstrapping_chebyshev.py`
(reference: src/pke/examples/
tckks-interactive-mp-bootstrapping-Chebyshev.cpp): three parties hold
shares of a joint key; a depleted ciphertext is refreshed by the
interactive MP bootstrap with COMPACT compression, then the reference's
Chebyshev series (cpp:248-260) is evaluated and threshold-decrypted. On
the GPU unless `--device cpu`:

    python examples_torch/tckks_interactive_mp_bootstrapping_chebyshev.py \
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

TOL = 5e-2
COEFFICIENTS = [1.0, 0.558971, 0.0, -0.0943712, 0.0, 0.0215023, 0.0,
                -0.00505348, 0.0, 0.00119324, 0.0, -0.000281928, 0.0,
                6.66001e-05, 0.0, -1.57274e-05]
A_LO, B_HI = -5.0, 5.0


def cheb_eval(coeffs, lo, hi, t):
    """The series with the c0 / 2 convention of EvalChebyshevSeries (the
    reference's EvalChebyshevSeriesPS)."""
    u = (2 * t - lo - hi) / (hi - lo)
    acc = coeffs[0] / 2.0 * np.ones_like(u)
    prev, cur = np.ones_like(u), u
    for c in coeffs[1:]:
        acc = acc + c * cur
        prev, cur = cur, 2 * u * cur - prev
    return acc


def main(device=None, ring_dim=256, mult_depth=10, scaling_mod_size=28,
         first_mod_size=30, security_level=SecurityLevel.HEStd_NotSet,
         seed=21, level=7) -> dict:
    """The series on the refreshed ciphertext, threshold-decrypted, beside
    what it should be, and the tower counts before and after."""
    print("Interactive (3P) Bootstrapping Ciphertext [Chebyshev] (TCKKS) "
          "started ...")
    params = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                      mult_depth=mult_depth,
                      scaling_mod_size=scaling_mod_size,
                      first_mod_size=first_mod_size, batch_size=16,
                      security_level=security_level,
                      scaling_technique=ScalingTechnique.FLEXIBLEAUTO,
                      interactive_boot_compression_level="COMPACT")
    cc = GenCryptoContext(params, seed=seed, device=device)
    for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
              PKESchemeFeature.LEVELEDSHE, PKESchemeFeature.ADVANCEDSHE,
              PKESchemeFeature.MULTIPARTY):
        cc.Enable(f)

    # the three parties' round-robin joint key
    kp1 = cc.MultipartyKeyGen()
    kp2 = cc.MultipartyKeyGen(kp1.public_key)
    kp3 = cc.MultipartyKeyGen(kp2.public_key)
    joint_pk = kp3.public_key
    tag = joint_pk.key_tag
    sks = [kp1.secret_key, kp2.secret_key, kp3.secret_key]

    # the joint relinearization key (the round-robin Multi* protocol)
    ek1 = cc.KeySwitchGen(kp1.secret_key, kp1.secret_key)
    ek2 = cc.MultiKeySwitchGen(kp2.secret_key, kp2.secret_key, ek1)
    ek3 = cc.MultiKeySwitchGen(kp3.secret_key, kp3.secret_key, ek2)
    ek123 = cc.MultiAddEvalKeys(cc.MultiAddEvalKeys(ek1, ek2, tag), ek3, tag)
    m1 = cc.MultiMultEvalKey(ek123, kp1.secret_key, tag)
    m2 = cc.MultiMultEvalKey(ek123, kp2.secret_key, tag)
    m3 = cc.MultiMultEvalKey(ek123, kp3.secret_key, tag)
    cc.InsertEvalMultKey(
        cc.MultiAddEvalMultKeys(cc.MultiAddEvalMultKeys(m1, m2, tag), m3,
                                tag), tag)

    # the secret input shared by the three parties (reference cpp:221)
    x = np.array([-4.0, -3.2, -2.1, -1.0, 0.0, 1.0, 2.1, 3.2])
    ct = cc.Encrypt(joint_pk, cc.MakeCKKSPackedPlaintext(x, slots=16))
    ct = cc.LevelReduce(ct, level)                   # deplete the budget
    before = cc.size_ql(ct.level)
    print("towers before interactive bootstrap:", before)

    # the interactive MP bootstrap: party 1 leads, the others share c1 s
    ct_adj = cc.IntMPBootAdjustScale(ct)
    a = cc.IntMPBootRandomElementGen(joint_pk)
    c1_only = ct_adj.replace(elements=(ct_adj.elements[1],))
    shares = [cc.IntMPBootDecrypt(sks[0], ct_adj, a)]
    shares += [cc.IntMPBootDecrypt(sk, c1_only, a) for sk in sks[1:]]
    fresh = cc.IntMPBootEncrypt(joint_pk, cc.IntMPBootAdd(shares), a,
                                ct_adj)
    after = cc.size_ql(fresh.level)
    print("towers after  interactive bootstrap:", after)
    assert after > before

    # the reference's series on [-5, 5], threshold-decrypted
    ct_cheb = cc.EvalChebyshevSeries(fresh, COEFFICIENTS, A_LO, B_HI)
    lead = cc.MultipartyDecryptLead([ct_cheb], sks[0])[0]
    mains = [cc.MultipartyDecryptMain([ct_cheb], sk)[0] for sk in sks[1:]]
    got = np.asarray(cc.MultipartyDecryptFusion(
        [lead] + mains, ct_cheb).values).real[:8]
    want = cheb_eval(COEFFICIENTS, A_LO, B_HI, x)
    err = np.abs(got - want).max()
    print("Chebyshev after refresh, max err:", err)
    assert err < TOL
    print("Interactive (3P) Bootstrapping Ciphertext [Chebyshev] (TCKKS) "
          "terminated gracefully!")
    return {"checks": {"chebyshev": close(got, want, TOL)},
            "towers": (before, after)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
