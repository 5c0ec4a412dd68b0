"""Proxy re-encryption of a full packed buffer on the port (BFV).

Counterpart of `examples/pre_buffer.py` (reference:
src/pke/examples/pre-buffer.cpp:63-238): Alice encrypts N random shorts,
re-targets them to Bob under INDCPA PRE, and both decryptions are checked
element for element, with each stage's time. On the GPU unless
`--device cpu`:

    python examples_torch/pre_buffer.py [--device cpu]
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from examples_torch import exact  # noqa: E402
from openfhe_tpu_torch import (CCParams, GenCryptoContext,  # noqa: E402
                               PKESchemeFeature, Scheme, SecurityLevel)
from openfhe_tpu_torch.pke.constants import (  # noqa: E402
    ProxyReEncryptionMode)
from openfhe_tpu_torch.utils.profiling import TIC, TOC_MS  # noqa: E402


def main(device=None, plaintext_modulus=65537, mult_depth=1,
         ring_dim=1 << 12, security_level=SecurityLevel.HEStd_NotSet,
         seed=0, data_seed=42) -> dict:
    """Alice's and Bob's decryptions of a ring-sized buffer (as 0 ...
    t - 1) beside the buffer, and each stage's ms."""
    t_mod = plaintext_modulus           # "can encode shorts"
    ms = {}
    print("setting up BFV RNS crypto system")
    t = TIC()
    params = CCParams(scheme=Scheme.BFVRNS_SCHEME, plaintext_modulus=t_mod,
                      mult_depth=mult_depth, ring_dim=ring_dim,
                      pre_mode=ProxyReEncryptionMode.INDCPA,
                      security_level=security_level)
    cc = GenCryptoContext(params, seed=seed, device=device)
    ms["params"] = TOC_MS(t)
    print(f"\nParam generation time: \t{ms['params']:.2f} ms")
    cc.Enable(PKESchemeFeature.PKE | PKESchemeFeature.KEYSWITCH
              | PKESchemeFeature.LEVELEDSHE | PKESchemeFeature.PRE)

    ringsize = cc.ring_dim
    print("p =", t_mod)
    print("n =", ringsize)
    print("log2 q =", round(sum(math.log2(q) for q in cc.moduli_q), 1))
    print(f"Alice can encrypt {ringsize * 2} bytes of data")

    print("\nRunning Alice key generation (used for source data)...")
    t = TIC()
    kp1 = cc.KeyGen()
    ms["alice keygen"] = TOC_MS(t, kp1.public_key.b)
    print(f"Key generation time: \t{ms['alice keygen']:.2f} ms")

    rng = np.random.default_rng(data_seed)
    v_shorts = rng.integers(0, 65536, size=ringsize)
    pt = cc.MakePackedPlaintext(v_shorts)

    t = TIC()
    ct1 = cc.Encrypt(kp1.public_key, pt)
    ms["encrypt"] = TOC_MS(t, ct1.elements[0])
    print(f"Encryption time: \t{ms['encrypt']:.2f} ms")
    t = TIC()
    dec1 = cc.Decrypt(kp1.secret_key, ct1)
    ms["alice decrypt"] = TOC_MS(t)
    print(f"Decryption time: \t{ms['alice decrypt']:.2f} ms")

    print("Bob Running key generation ...")
    t = TIC()
    kp2 = cc.KeyGen()
    ms["bob keygen"] = TOC_MS(t, kp2.public_key.b)
    print(f"Key generation time: \t{ms['bob keygen']:.2f} ms")

    print("\nGenerating proxy re-encryption key...")
    t = TIC()
    rk12 = cc.ReKeyGen(kp1.secret_key, kp2.public_key)
    ms["rekeygen"] = TOC_MS(t, rk12.bv)
    print(f"Key generation time: \t{ms['rekeygen']:.2f} ms")

    t = TIC()
    ct2 = cc.ReEncrypt(ct1, rk12)
    ms["reencrypt"] = TOC_MS(t, ct2.elements[0])
    print(f"Re-Encryption time: \t{ms['reencrypt']:.2f} ms")
    t = TIC()
    dec2 = cc.Decrypt(kp2.secret_key, ct2)
    ms["bob decrypt"] = TOC_MS(t)
    print(f"Decryption time: \t{ms['bob decrypt']:.2f} ms")

    # plaintexts decode centered in (-p/2, p/2]; shift back to 0..p-1
    def unsigned(v):
        v = np.asarray(v[:ringsize])
        return np.where(v < 0, v + t_mod, v)

    u1, u2 = unsigned(dec1.values), unsigned(dec2.values)
    good = np.array_equal(u1, v_shorts) and np.array_equal(u2, v_shorts)
    print("PRE passes" if good else "PRE fails")
    print("Execution Completed.")
    assert good
    return {"checks": {"alice": exact(u1, v_shorts),
                       "bob": exact(u2, v_shorts)}, "ms": ms}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
