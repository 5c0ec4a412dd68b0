"""Encrypted inner products on the port: exact (BFV) and approximate (CKKS).

Counterpart of `examples/inner_product.py` (reference:
src/pke/examples/inner-product.cpp), on the GPU unless `--device cpu`:

    python examples_torch/inner_product.py [--device cpu]
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

TOL = 1e-2
FEATURES = (PKESchemeFeature.PKE | PKESchemeFeature.KEYSWITCH
            | PKESchemeFeature.LEVELEDSHE | PKESchemeFeature.ADVANCEDSHE)


def bfv_inner_product(device, ring_dim, security_level, seed) -> tuple:
    p = CCParams(scheme=Scheme.BFVRNS_SCHEME, ring_dim=ring_dim,
                 mult_depth=2, plaintext_modulus=65537, batch_size=8,
                 security_level=security_level)
    cc = GenCryptoContext(p, seed=seed, device=device)
    cc.Enable(FEATURES)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)
    cc.EvalSumKeyGen(kp.secret_key)

    a = np.array([1, 2, 3, 4, 5, 6, 7, 8])
    b = np.array([8, 7, 6, 5, 4, 3, 2, 1])
    ca = cc.Encrypt(kp.public_key, cc.MakePackedPlaintext(a))
    cb = cc.Encrypt(kp.public_key, cc.MakePackedPlaintext(b))
    res = cc.EvalInnerProduct(ca, cb, 8)
    got = int(np.asarray(cc.Decrypt(kp.secret_key, res).values)[0])
    print("BFV  <a,b> =", got, "expected", int(a @ b))
    assert got == a @ b
    return exact(got, int(a @ b))


def ckks_inner_product(device, ring_dim, security_level, seed) -> tuple:
    p = CCParams(scheme=Scheme.CKKSRNS_SCHEME, ring_dim=ring_dim,
                 mult_depth=3, scaling_mod_size=28, first_mod_size=30,
                 batch_size=8, security_level=security_level,
                 scaling_technique=ScalingTechnique.FLEXIBLEAUTO)
    cc = GenCryptoContext(p, seed=seed, device=device)
    cc.Enable(FEATURES)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)
    cc.EvalSumKeyGen(kp.secret_key)

    a = np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8])
    b = np.array([-0.8, 0.7, -0.6, 0.5, -0.4, 0.3, -0.2, 0.1])
    ca = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(a, slots=8))
    cb = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(b, slots=8))
    res = cc.EvalInnerProduct(ca, cb, 8)
    got = float(np.asarray(cc.Decrypt(kp.secret_key, res).values).real[0])
    print("CKKS <a,b> =", round(got, 5), "expected", round(float(a @ b), 5))
    assert abs(got - a @ b) < TOL
    return close(got, float(a @ b), TOL)


def main(device=None, bfv_ring_dim=1024, ckks_ring_dim=512,
         security_level=SecurityLevel.HEStd_NotSet, bfv_seed=2,
         ckks_seed=3) -> dict:
    """<a, b> over 8 slots in BFV and in CKKS; returns each decryption
    beside what it should be."""
    out = {"checks": {
        "BFV <a,b>": bfv_inner_product(device, bfv_ring_dim, security_level,
                                       bfv_seed),
        "CKKS <a,b>": ckks_inner_product(device, ckks_ring_dim,
                                         security_level, ckks_seed)}}
    print("inner product OK")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
