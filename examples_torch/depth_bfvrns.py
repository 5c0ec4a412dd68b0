"""Depth-3 BFV on the port: (a*b*c) + (a*b) exact mod t, two techniques.

Counterpart of `examples/depth_bfvrns.py` (reference:
src/pke/examples/depth-bfvrns.cpp and depth-bfvrns-behz.cpp), on the GPU
unless `--device cpu`:

    python examples_torch/depth_bfvrns.py [--device cpu]
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
from openfhe_tpu_torch.pke.constants import (  # noqa: E402
    EncryptionTechnique, MultiplicationTechnique)


def main(device=None, plaintext_modulus=12289, mult_depth=3,
         ring_dim=1 << 10, security_level=SecurityLevel.HEStd_NotSet,
         seed=6) -> dict:
    """The program under HPSPOVERQLEVELED / STANDARD and BEHZ / EXTENDED;
    returns each decryption beside what it should be."""
    t = plaintext_modulus
    checks = {}
    for mult_tech, enc_tech in (
            (MultiplicationTechnique.HPSPOVERQLEVELED,
             EncryptionTechnique.STANDARD),
            (MultiplicationTechnique.BEHZ, EncryptionTechnique.EXTENDED)):
        params = CCParams(scheme=Scheme.BFVRNS_SCHEME, plaintext_modulus=t,
                          mult_depth=mult_depth, ring_dim=ring_dim,
                          security_level=security_level,
                          multiplication_technique=mult_tech,
                          encryption_technique=enc_tech)
        cc = GenCryptoContext(params, seed=seed, device=device)
        for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
                  PKESchemeFeature.LEVELEDSHE):
            cc.Enable(f)
        keys = cc.KeyGen()
        cc.EvalMultKeyGen(keys.secret_key)
        a = np.array([3, 1, 4, 1, 5, 9, 2, 6], dtype=np.int64)
        b = np.array([2, 7, 1, 8, 2, 8, 1, 8], dtype=np.int64)
        c = np.array([1, 6, 1, 8, 0, 3, 3, 9], dtype=np.int64)
        ca = cc.Encrypt(keys.public_key, cc.MakePackedPlaintext(a))
        cb = cc.Encrypt(keys.public_key, cc.MakePackedPlaintext(b))
        ctc = cc.Encrypt(keys.public_key, cc.MakePackedPlaintext(c))
        ab = cc.EvalMult(ca, cb)
        abc = cc.EvalMult(ab, ctc)
        res = cc.EvalAdd(abc, ab)
        got = np.asarray(cc.Decrypt(keys.secret_key, res).values[:8]) % t
        want = (a * b * c + a * b) % t
        label = f"{mult_tech.name}/{enc_tech.name}"
        print(f"{label}: exact={np.array_equal(got, want)}")
        assert np.array_equal(got, want)
        checks[label] = exact(got, want)
    print("OK")
    return {"checks": checks}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
