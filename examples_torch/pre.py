"""Proxy re-encryption on the port: re-target a ciphertext to another key.

Counterpart of `examples/pre.py`, the minimal PRE demo, on the GPU
unless `--device cpu`:

    python examples_torch/pre.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from openfhe_tpu_torch import (CCParams, GenCryptoContext,  # noqa: E402
                               PKESchemeFeature, Scheme, SecurityLevel)


def main(device=None, plaintext_modulus=65537, mult_depth=2,
         ring_dim=1 << 11, security_level=SecurityLevel.HEStd_NotSet,
         seed=0) -> dict:
    """Alice encrypts, Bob decrypts after a re-encryption under a key
    from Alice's secret to Bob's public key; returns what Bob reads."""
    params = CCParams(scheme=Scheme.BGVRNS_SCHEME,
                      plaintext_modulus=plaintext_modulus,
                      mult_depth=mult_depth, ring_dim=ring_dim,
                      security_level=security_level)
    cc = GenCryptoContext(params, seed=seed, device=device)
    cc.Enable(PKESchemeFeature.PKE)
    cc.Enable(PKESchemeFeature.KEYSWITCH)
    cc.Enable(PKESchemeFeature.LEVELEDSHE)
    cc.Enable(PKESchemeFeature.PRE)

    alice = cc.KeyGen()
    bob = cc.KeyGen()

    v = np.array([4, 8, 15, 16, 23, 42])
    ct_alice = cc.Encrypt(alice.public_key, cc.MakePackedPlaintext(v))

    # Alice authorizes Bob: re-encryption key from Alice's sk to Bob's pk
    rk = cc.ReKeyGen(alice.secret_key, bob.public_key)
    ct_bob = cc.ReEncrypt(ct_alice, rk)

    got = np.asarray(cc.Decrypt(bob.secret_key, ct_bob).values)[:6]
    print("Bob decrypts:", got, "exact:", np.array_equal(got, v))
    return {"got": got, "want": v}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
