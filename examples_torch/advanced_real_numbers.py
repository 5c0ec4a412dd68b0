"""Advanced CKKS on the port: manual and automatic rescaling, hoisting.

Counterpart of `examples/advanced_real_numbers.py` (reference:
src/pke/examples/advanced-real-numbers.cpp), on the GPU unless
`--device cpu`:

    python examples_torch/advanced_real_numbers.py [--device cpu]
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

TOL = 1e-3
X = np.array([1.0, 1.01, 1.02, 1.03, 1.04, 1.05, 1.06, 1.07])


def demo(technique, device, ring_dim, mult_depth, security_level, seed):
    """x^3 + x under `technique`; returns the context, keys, the input
    ciphertext and the check."""
    params = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                      mult_depth=mult_depth, scaling_mod_size=28,
                      first_mod_size=30, batch_size=8,
                      security_level=security_level,
                      scaling_technique=technique)
    cc = GenCryptoContext(params, seed=seed, device=device)
    for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
              PKESchemeFeature.LEVELEDSHE):
        cc.Enable(f)
    keys = cc.KeyGen()
    cc.EvalMultKeyGen(keys.secret_key)
    ct = cc.Encrypt(keys.public_key, cc.MakeCKKSPackedPlaintext(X, slots=8))
    # c * c -> (manual: Rescale) -> * c -> + c
    c2 = cc.EvalMult(ct, ct)
    if technique == ScalingTechnique.FIXEDMANUAL:
        c2 = cc.Rescale(c2)
    c3 = cc.EvalAdd(cc.EvalMult(c2, ct), ct)
    got = np.asarray(cc.Decrypt(keys.secret_key, c3).values).real[:8]
    want = X ** 3 + X
    print(f"{technique.name}: max err {np.abs(got - want).max():.2e}")
    assert np.abs(got - want).max() < TOL
    return cc, keys, ct, close(got, want, TOL)


def main(device=None, ring_dim=256, mult_depth=5,
         security_level=SecurityLevel.HEStd_NotSet, seed=3) -> dict:
    """x^3 + x under FIXEDMANUAL and FLEXIBLEAUTO, then hoisted rotations
    by 1, 2, 3; returns each decryption beside what it should be."""
    checks = {}
    cc, keys, ct, checks["FIXEDMANUAL x^3+x"] = demo(
        ScalingTechnique.FIXEDMANUAL, device, ring_dim, mult_depth,
        security_level, seed)
    checks["FLEXIBLEAUTO x^3+x"] = demo(
        ScalingTechnique.FLEXIBLEAUTO, device, ring_dim, mult_depth,
        security_level, seed)[3]

    # hoisted rotations: one precomputation shared by many rotations
    cc.EvalRotateKeyGen(keys.secret_key, [1, 2, 3])
    pre = cc.EvalFastRotationPrecompute(ct)
    for r in (1, 2, 3):
        rot = cc.EvalFastRotation(ct, r, 2 * cc.ring_dim, pre)
        got = np.asarray(cc.Decrypt(keys.secret_key, rot).values).real[:8 - r]
        assert np.abs(got - X[r:]).max() < TOL
        checks[f"fastrot({r})"] = close(got, X[r:], TOL)
    print("hoisted rotations OK")
    return {"checks": checks}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
