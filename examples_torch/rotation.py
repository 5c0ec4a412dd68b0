"""Slot rotations on the port: BFV rotations and hoisted CKKS rotations.

Counterpart of `examples/rotation.py` (reference:
src/pke/examples/rotation.cpp), on the GPU unless `--device cpu`:

    python examples_torch/rotation.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from examples_torch import close, exact  # noqa: E402
from openfhe_tpu_torch import (CCParams, GenCryptoContext,  # noqa: E402
                               PKESchemeFeature, ScalingTechnique, Scheme,
                               SecurityLevel)

TOL = 1e-3


def bfv_rotation(device, ring_dim, security_level, seed) -> dict:
    p = CCParams(scheme=Scheme.BFVRNS_SCHEME, ring_dim=ring_dim,
                 mult_depth=1, plaintext_modulus=65537, batch_size=8,
                 security_level=security_level)
    cc = GenCryptoContext(p, seed=seed, device=device)
    cc.Enable(PKESchemeFeature.PKE | PKESchemeFeature.KEYSWITCH
              | PKESchemeFeature.LEVELEDSHE)
    kp = cc.KeyGen()
    cc.EvalRotateKeyGen(kp.secret_key, [1, 2, -1])

    x = np.arange(1, 9)
    ct = cc.Encrypt(kp.public_key, cc.MakePackedPlaintext(x))
    # rotations act on the full slot row (N/2 slots); unfilled slots are 0
    row = np.zeros(cc.ring_dim // 2, np.int64)
    row[:8] = x
    checks = {}
    for r in (1, 2, -1):
        got = np.asarray(cc.Decrypt(kp.secret_key,
                                    cc.EvalRotate(ct, r)).values[:8])
        want = np.roll(row, -r)[:8]
        print(f"BFV  rot({r:+d}) =", got)
        assert np.array_equal(got, want)
        checks[f"BFV rot({r:+d})"] = exact(got, want)
    return checks


def ckks_hoisted_rotations(device, ring_dim, security_level, seed) -> dict:
    p = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                 mult_depth=2, scaling_mod_size=28, first_mod_size=30,
                 batch_size=8, security_level=security_level,
                 scaling_technique=ScalingTechnique.FLEXIBLEAUTO)
    cc = GenCryptoContext(p, seed=seed, device=device)
    cc.Enable(PKESchemeFeature.PKE | PKESchemeFeature.KEYSWITCH
              | PKESchemeFeature.LEVELEDSHE)
    kp = cc.KeyGen()
    rots = [1, 2, 3]
    cc.EvalRotateKeyGen(kp.secret_key, rots)

    x = np.linspace(-1, 1, 8)
    ct = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(x, slots=8))
    # hoisting: one digit decomposition shared by all rotations
    digits = cc.EvalFastRotationPrecompute(ct)
    checks = {}
    for r in rots:
        res = cc.EvalFastRotation(ct, r, 2 * cc.ring_dim, digits)
        got = np.asarray(cc.Decrypt(kp.secret_key, res).values).real[:8]
        assert np.abs(got - np.roll(x, -r)).max() < TOL
        print(f"CKKS fastrot({r:+d}) ~", np.round(got[:4], 4))
        checks[f"CKKS fastrot({r:+d})"] = close(got, np.roll(x, -r), TOL)
    return checks


def main(device=None, bfv_ring_dim=1024, ckks_ring_dim=512,
         security_level=SecurityLevel.HEStd_NotSet, bfv_seed=4,
         ckks_seed=5) -> dict:
    """BFV rotations by 1, 2, -1 and CKKS hoisted rotations by 1, 2, 3;
    returns each decryption beside what it should be."""
    checks = bfv_rotation(device, bfv_ring_dim, security_level, bfv_seed)
    checks.update(ckks_hoisted_rotations(device, ckks_ring_dim,
                                         security_level, ckks_seed))
    print("rotation OK")
    return {"checks": checks}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
