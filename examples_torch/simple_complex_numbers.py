"""CKKS complex arithmetic on the port: complex inputs and scalars.

Counterpart of `examples/simple_complex_numbers.py` (reference:
src/pke/examples/simple-complex-numbers.cpp), on the GPU unless
`--device cpu`:

    python examples_torch/simple_complex_numbers.py [--device cpu]
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

TOL = 1e-2


def main(device=None, ring_dim=512, mult_depth=3, scaling_mod_size=28,
         first_mod_size=30, security_level=SecurityLevel.HEStd_NotSet,
         seed=10) -> dict:
    """z * w, z * 1j and z + (1 - 2j) on 8 complex slots; returns each
    decryption beside what it should be. `ring_dim=0` lets the security
    tables choose N."""
    p = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                 mult_depth=mult_depth, scaling_mod_size=scaling_mod_size,
                 first_mod_size=first_mod_size, batch_size=8,
                 security_level=security_level,
                 scaling_technique=ScalingTechnique.FLEXIBLEAUTO)
    cc = GenCryptoContext(p, seed=seed, device=device)
    cc.Enable(PKESchemeFeature.PKE | PKESchemeFeature.KEYSWITCH
              | PKESchemeFeature.LEVELEDSHE)
    print(f"CKKS ring dimension {cc.GetRingDimension()}")
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)

    z = np.array([1 + 1j, 2 - 1j, -0.5 + 0.25j, 0.75, 1j, -1j, 0.5 + 0.5j,
                  -0.25 - 0.75j])
    w = np.array([0.5 - 0.5j] * 8)
    cz = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(z, slots=8))
    cw = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(w, slots=8))

    def dec(ct):
        return np.asarray(cc.Decrypt(kp.secret_key, ct).values)[:8]

    out = {"checks": {
        "z*w": close(dec(cc.EvalMult(cz, cw)), z * w, TOL),
        "z*1j": close(dec(cc.EvalMult(cz, 1j)), z * 1j, TOL),
        "z+(1-2j)": close(dec(cc.EvalAdd(cz, 1 - 2j)), z + 1 - 2j, TOL)},
        "ring_dim": cc.GetRingDimension()}
    print("z*w      =", np.round(out["checks"]["z*w"][0], 4))
    for got, want, tol in out["checks"].values():
        assert np.abs(got - want).max() < tol
    print("complex arithmetic OK")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
