"""HRA-secure proxy re-encryption on the port: two hops, two modes (BGV).

Counterpart of `examples/pre_hra_secure.py` (reference:
src/pke/examples/pre-hra-secure.cpp): ReEncrypt under FIXED_NOISE_HRA and
NOISE_FLOODING_HRA along alice -> bob -> charlie. On the GPU unless
`--device cpu`:

    python examples_torch/pre_hra_secure.py [--device cpu]
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
    ProxyReEncryptionMode)


def main(device=None, plaintext_modulus=12289, mult_depth=2,
         ring_dim=1 << 10, security_level=SecurityLevel.HEStd_NotSet,
         seed=5) -> dict:
    """Charlie's decryption after two re-encryptions, in each mode,
    beside what Alice encrypted."""
    checks = {}
    for mode in (ProxyReEncryptionMode.FIXED_NOISE_HRA,
                 ProxyReEncryptionMode.NOISE_FLOODING_HRA):
        params = CCParams(scheme=Scheme.BGVRNS_SCHEME,
                          plaintext_modulus=plaintext_modulus,
                          mult_depth=mult_depth, ring_dim=ring_dim,
                          security_level=security_level, pre_mode=mode)
        cc = GenCryptoContext(params, seed=seed, device=device)
        for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
                  PKESchemeFeature.LEVELEDSHE, PKESchemeFeature.PRE):
            cc.Enable(f)
        alice, bob, charlie = cc.KeyGen(), cc.KeyGen(), cc.KeyGen()
        v = np.array([1, 2, 3, 5, 8, 13])
        ct = cc.Encrypt(alice.public_key, cc.MakePackedPlaintext(v))
        rk_ab = cc.ReKeyGen(alice.secret_key, bob.public_key)
        rk_bc = cc.ReKeyGen(bob.secret_key, charlie.public_key)
        ct_b = cc.ReEncrypt(ct, rk_ab, bob.public_key)
        ct_c = cc.ReEncrypt(ct_b, rk_bc, charlie.public_key)
        got = np.asarray(cc.Decrypt(charlie.secret_key, ct_c).values[:6])
        print(f"{mode.name}: two-hop decrypt {got} "
              f"exact={np.array_equal(got, v)}")
        assert np.array_equal(got, v)
        checks[mode.name] = exact(got, v)
    print("OK")
    return {"checks": checks}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
