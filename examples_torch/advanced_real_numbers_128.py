"""Advanced CKKS at 78-bit composite scales on the port.

Counterpart of `examples/advanced_real_numbers_128.py` (reference:
src/pke/examples/advanced-real-numbers-128.cpp, which builds with
NATIVEINT=128; here a 78-bit scale is three 27-bit word primes under
COMPOSITESCALING): automatic and manual rescaling, HYBRID and BV key
switching, hoisted rotations. On the GPU unless `--device cpu`:

    python examples_torch/advanced_real_numbers_128.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from examples_torch import close  # noqa: E402
from openfhe_tpu_torch import (CCParams, GenCryptoContext,  # noqa: E402
                               KeySwitchTechnique, PKESchemeFeature,
                               ScalingTechnique, Scheme, SecurityLevel)

TOL = 1e-8      # about 2^-30 at 78-bit scales
X = np.array([1.0, 1.01, 1.02, 1.03, 1.04, 1.05, 1.06, 1.07])


def main(device=None, ring_dim=256, mult_depth=7, scaling_mod_size=78,
         first_mod_size=89, composite_degree=3, register_word_size=27,
         security_level=SecurityLevel.HEStd_NotSet, seed=3) -> dict:
    """x^18 + x^9 + 1 with automatic and manual rescaling, a rotation under
    HYBRID and BV key switching, hoisted rotations; returns each
    decryption beside what it should be."""

    def make_cc(technique, ks=KeySwitchTechnique.HYBRID, digit_size=0):
        # depth 7 (the reference's 5): composite-group products drift
        # about 2e-4 between levels, which two spare levels absorb
        params = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                          mult_depth=mult_depth,
                          scaling_mod_size=scaling_mod_size,
                          first_mod_size=first_mod_size,
                          composite_degree=composite_degree,
                          register_word_size=register_word_size,
                          batch_size=8, ks_technique=ks,
                          digit_size=digit_size,
                          security_level=security_level,
                          scaling_technique=technique)
        cc = GenCryptoContext(params, seed=seed, device=device)
        for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
                  PKESchemeFeature.LEVELEDSHE):
            cc.Enable(f)
        return cc

    def dec(cc, keys, ct, lo=0, hi=8):
        return np.asarray(cc.Decrypt(keys.secret_key, ct).values).real[lo:hi]

    checks = {}
    want = X ** 18 + X ** 9 + 1

    # AutomaticRescaleDemo: no manual rescaling
    cc = make_cc(ScalingTechnique.COMPOSITESCALINGAUTO)
    keys = cc.KeyGen()
    cc.EvalMultKeyGen(keys.secret_key)
    ct = cc.Encrypt(keys.public_key, cc.MakeCKKSPackedPlaintext(X, slots=8))
    c2 = cc.EvalMult(ct, ct)                       # x^2
    c4 = cc.EvalMult(c2, c2)                       # x^4
    c8 = cc.EvalMult(c4, c4)                       # x^8
    c9 = cc.EvalMult(c8, ct)                       # x^9
    c18 = cc.EvalMult(c9, c9)                      # x^18
    got = dec(cc, keys, cc.EvalAdd(cc.EvalAdd(c18, c9), 1.0))
    print(f"AutomaticRescaleDemo x^18+x^9+1: max err "
          f"{np.abs(got - want).max():.2e}")
    assert np.abs(got - want).max() < TOL
    checks["automatic x^18+x^9+1"] = close(got, want, TOL)

    # ManualRescaleDemo: the same with explicit Rescale calls
    cc = make_cc(ScalingTechnique.COMPOSITESCALINGMANUAL)
    keys = cc.KeyGen()
    cc.EvalMultKeyGen(keys.secret_key)
    ct = cc.Encrypt(keys.public_key, cc.MakeCKKSPackedPlaintext(X, slots=8))
    c2 = cc.Rescale(cc.EvalMult(ct, ct))
    c4 = cc.Rescale(cc.EvalMult(c2, c2))
    c8 = cc.Rescale(cc.EvalMult(c4, c4))
    ct_l3 = cc.LevelReduce(ct, 3)                   # match levels for x^9
    c9 = cc.Rescale(cc.EvalMult(c8, ct_l3))
    c18 = cc.Rescale(cc.EvalMult(c9, c9))
    c9_down = cc.LevelReduce(c9, c18.level - c9.level)
    got = dec(cc, keys, cc.EvalAdd(cc.EvalAdd(c18, c9_down), 1.0))
    print(f"ManualRescaleDemo    x^18+x^9+1: max err "
          f"{np.abs(got - want).max():.2e}")
    assert np.abs(got - want).max() < TOL
    checks["manual x^18+x^9+1"] = close(got, want, TOL)

    # the same rotation under HYBRID and BV key switching
    for ks, digit in ((KeySwitchTechnique.HYBRID, 0),
                      (KeySwitchTechnique.BV, 9)):
        cc = make_cc(ScalingTechnique.COMPOSITESCALINGAUTO, ks, digit)
        keys = cc.KeyGen()
        cc.EvalMultKeyGen(keys.secret_key)
        cc.EvalRotateKeyGen(keys.secret_key, [1])
        ct = cc.Encrypt(keys.public_key,
                        cc.MakeCKKSPackedPlaintext(X, slots=8))
        got = dec(cc, keys, cc.EvalRotate(ct, 1), 0, 7)
        print(f"{ks.name} key switching rotation: max err "
              f"{np.abs(got - X[1:]).max():.2e}")
        assert np.abs(got - X[1:]).max() < TOL
        checks[f"{ks.name} rot(1)"] = close(got, X[1:], TOL)

    # hoisted rotations sharing one decomposition
    cc = make_cc(ScalingTechnique.COMPOSITESCALINGAUTO)
    keys = cc.KeyGen()
    cc.EvalRotateKeyGen(keys.secret_key, [1, 2, 3])
    ct = cc.Encrypt(keys.public_key, cc.MakeCKKSPackedPlaintext(X, slots=8))
    pre = cc.EvalFastRotationPrecompute(ct)
    for r in (1, 2, 3):
        rot = cc.EvalFastRotation(ct, r, 2 * cc.ring_dim, pre)
        got = dec(cc, keys, rot, 0, 8 - r)
        assert np.abs(got - X[r:]).max() < TOL
        checks[f"fastrot({r})"] = close(got, X[r:], TOL)
    print("hoisted rotations OK (128-bit-class precision)")
    return {"checks": checks}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
