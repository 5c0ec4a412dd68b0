"""Serialized large-precision FHEW workflow on the port (binary and JSON).

Counterpart of `examples/boolean_serial_large_precision.py` (reference:
src/binfhe/examples/boolean-serial-binary-dynamic-large-precision.cpp and
boolean-serial-json-dynamic-large-precision.cpp): the secret key, the
switching and refresh keys and a p = 16 ciphertext written; a fresh
"server" context restores them and runs EvalFloor. Files go to a
temporary directory. On the GPU unless `--device cpu`:

    python examples_torch/boolean_serial_large_precision.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from examples_torch import exact, one  # noqa: E402
from openfhe_tpu_torch.binfhe.context import BinFHEContext  # noqa: E402
from openfhe_tpu_torch.utils.serialization import (  # noqa: E402
    SerType, deserialize_from_file, serialize_to_file)


def main(device=None, n=64, N=1024, q=1024, q_bits=27, base_ks=25,
         base_g=512, seed=0, m=13, p_large=16) -> dict:
    """floor(13 >> 2) on restored keys, in binary and in JSON; returns
    each decryption beside what it should be."""

    def fresh_cc():
        # TOY-class lattice with a 27-bit accumulator modulus for large
        # plaintext precision (reference: GenerateBinFHEContext(TOY,
        # false, logQ=17, 0, GINX, true))
        return BinFHEContext(seed, device=device).GenerateBinFHEContextCustom(
            n=n, N=N, q=q, q_bits=q_bits, base_ks=base_ks, base_g=base_g)

    cc1 = fresh_cc()
    sk1 = cc1.KeyGen()
    cc1.BTKeyGen(sk1)
    q_large = cc1.q * (p_large // 4)
    ct1 = cc1.Encrypt(sk1, m, p=p_large, q=q_large)

    checks = {}
    for st, name in ((SerType.BINARY, "bin"), (SerType.JSON, "json")):
        with tempfile.TemporaryDirectory() as d:
            def path(stem):
                return os.path.join(d, f"{stem}.{name}")

            for obj, stem in ((sk1, "sk"), (cc1.ks_key, "ksKey"),
                              (cc1.bt_key, "refreshKey"), (ct1, "ct")):
                serialize_to_file(path(stem), obj, st)
            size = sum(os.path.getsize(os.path.join(d, f))
                       for f in os.listdir(d))
            print(f"[{name}] keys + ciphertext serialized ({size} bytes)")

            # the "server": a fresh context with the restored keys
            cc2 = fresh_cc()
            sk2 = deserialize_from_file(path("sk"), st, device=cc2.device)
            cc2.ks_key = deserialize_from_file(path("ksKey"), st,
                                               device=cc2.device)
            cc2.bt_key = deserialize_from_file(path("refreshKey"), st,
                                               device=cc2.device)
            ct = deserialize_from_file(path("ct"), st, device=cc2.device)
            got = one(cc2.Decrypt(sk2, cc2.EvalFloor(ct, 2),
                                  p=p_large >> 2))
            print(f"[{name}] floor({m} >> 2) on restored keys -> {got}")
            assert got == m >> 2
            checks[f"{name} floor"] = exact(got, m >> 2)
    print("boolean-serial large-precision: OK")
    return {"checks": checks}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
