"""Serialized FHEW workflow with public-key encryption on the port.

Counterpart of `examples/boolean_serial_pke.py` (reference:
src/binfhe/examples/pke/boolean-serial-binary-pke.cpp and
boolean-serial-json-pke.cpp): public-key encryptions written, read back
on the "server", a gate evaluated. Files go to a temporary directory. On
the GPU unless `--device cpu`:

    python examples_torch/boolean_serial_pke.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from examples_torch import exact, one  # noqa: E402
from openfhe_tpu_torch.binfhe.constants import (BINGATE,  # noqa: E402
                                                KEYGEN_MODE)
from openfhe_tpu_torch.binfhe.context import BinFHEContext  # noqa: E402
from openfhe_tpu_torch.utils.serialization import (  # noqa: E402
    SerType, deserialize_from_file, serialize_to_file)


def main(device=None, param_set="TOY", seed=0) -> dict:
    """OR(1, 0) of public-key encryptions on restored objects, in binary
    and in JSON; returns each decryption beside what it should be."""
    cc = BinFHEContext(seed, device=device)
    cc.GenerateBinFHEContext(param_set)
    sk = cc.KeyGen()
    cc.BTKeyGen(sk, keygen_mode=KEYGEN_MODE.PUB_ENCRYPT)
    pk = cc.GetPublicKey()

    ct1 = cc.Encrypt(pk, 1)
    ct2 = cc.Encrypt(pk, 0)
    checks = {}
    with tempfile.TemporaryDirectory() as d:
        for st, name in ((SerType.BINARY, "bin"), (SerType.JSON, "json")):
            for obj, stem in ((sk, "sk"), (ct1, "ct1"), (ct2, "ct2")):
                serialize_to_file(os.path.join(d, f"{stem}.{name}"), obj, st)
            sk2, c1, c2 = (deserialize_from_file(
                os.path.join(d, f"{stem}.{name}"), st, device=cc.device)
                for stem in ("sk", "ct1", "ct2"))
            got = one(cc.Decrypt(sk2, cc.EvalBinGate(BINGATE.OR, c1, c2)))
            print(f"{name}: OR(1,0) = {got}")
            assert got == 1
            checks[f"{name} OR(1,0)"] = exact(got, 1)
    print("OK")
    return {"checks": checks}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
