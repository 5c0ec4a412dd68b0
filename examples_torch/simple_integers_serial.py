"""Serialized BFV and BGV workflow on the port (client / server split).

Counterpart of `examples/simple_integers_serial.py` (reference:
src/pke/examples/simple-integers-serial.cpp and
simple-integers-serial-bgvrns.cpp): the client writes its ciphertexts,
the server multiplies the restored ones and writes the product, the
client decrypts it. Files go to a temporary directory. On the GPU unless
`--device cpu`:

    python examples_torch/simple_integers_serial.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from examples_torch import exact  # noqa: E402
from openfhe_tpu_torch import (CCParams, GenCryptoContext,  # noqa: E402
                               PKESchemeFeature, Scheme, SecurityLevel)
from openfhe_tpu_torch.utils.serialization import (  # noqa: E402
    deserialize_from_file, serialize_to_file)


def main(device=None, plaintext_modulus=12289, mult_depth=2,
         ring_dim=1 << 10, security_level=SecurityLevel.HEStd_NotSet,
         seed=15) -> dict:
    """v1 * v2 through files under BFV and BGV; returns each decryption
    beside what it should be."""
    t = plaintext_modulus
    checks = {}
    for scheme in (Scheme.BFVRNS_SCHEME, Scheme.BGVRNS_SCHEME):
        params = CCParams(scheme=scheme, plaintext_modulus=t,
                          mult_depth=mult_depth, ring_dim=ring_dim,
                          security_level=security_level)
        cc = GenCryptoContext(params, seed=seed, device=device)
        for f in (PKESchemeFeature.PKE, PKESchemeFeature.KEYSWITCH,
                  PKESchemeFeature.LEVELEDSHE):
            cc.Enable(f)
        keys = cc.KeyGen()
        cc.EvalMultKeyGen(keys.secret_key)
        v1 = np.array([1, 2, 3, 4, 5, 6], dtype=np.int64)
        v2 = np.array([7, 8, 9, 10, 11, 12], dtype=np.int64)
        c1 = cc.Encrypt(keys.public_key, cc.MakePackedPlaintext(v1))
        c2 = cc.Encrypt(keys.public_key, cc.MakePackedPlaintext(v2))
        with tempfile.TemporaryDirectory() as d:
            serialize_to_file(os.path.join(d, "c1"), c1)
            serialize_to_file(os.path.join(d, "c2"), c2)
            # the "server": restore and evaluate
            s1 = deserialize_from_file(os.path.join(d, "c1"),
                                       device=cc.device)
            s2 = deserialize_from_file(os.path.join(d, "c2"),
                                       device=cc.device)
            serialize_to_file(os.path.join(d, "out"), cc.EvalMult(s1, s2))
            # the "client": restore and decrypt
            res = deserialize_from_file(os.path.join(d, "out"),
                                        device=cc.device)
            got = np.asarray(cc.Decrypt(keys.secret_key,
                                        res).values[:6]) % t
        want = (v1 * v2) % t
        print(f"{scheme.value}: {got} exact={np.array_equal(got, want)}")
        assert np.array_equal(got, want)
        checks[scheme.name] = exact(got, want)
    print("OK")
    return {"checks": checks}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
