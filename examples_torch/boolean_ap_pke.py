"""FHEW gates under AP bootstrapping on public-key encryptions (the port).

Counterpart of `examples/boolean_ap_pke.py` (reference:
src/binfhe/examples/pke/boolean-ap-pke.cpp), on the GPU unless
`--device cpu`:

    python examples_torch/boolean_ap_pke.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from examples_torch import exact, one  # noqa: E402
from openfhe_tpu_torch.binfhe.constants import (BINGATE,  # noqa: E402
                                                KEYGEN_MODE)
from openfhe_tpu_torch.binfhe.context import BinFHEContext  # noqa: E402


def main(device=None, param_set="TOY", seed=0) -> dict:
    """1 AND 1 and 1 NAND 1 on public-key encryptions; returns each
    decryption beside what it should be."""
    cc = BinFHEContext(seed, device=device).GenerateBinFHEContext(
        param_set, method="AP")
    sk = cc.KeyGen()
    print("generating bootstrapping keys (AP)...")
    cc.BTKeyGen(sk, keygen_mode=KEYGEN_MODE.PUB_ENCRYPT)
    pk = cc.GetPublicKey()

    ct1 = cc.Encrypt(pk, 1)
    ct2 = cc.Encrypt(pk, 1)
    r_and = one(cc.Decrypt(sk, cc.EvalBinGate(BINGATE.AND, ct1, ct2)))
    print("1 AND 1 =", r_and)
    assert r_and == 1
    r_nand = one(cc.Decrypt(sk, cc.EvalBinGate(BINGATE.NAND, ct1, ct2)))
    print("1 NAND 1 =", r_nand)
    assert r_nand == 0
    print("OK")
    return {"checks": {"1 AND 1": exact(r_and, 1),
                       "1 NAND 1": exact(r_nand, 0)}}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
