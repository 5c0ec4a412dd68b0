"""FHEW/TFHE Boolean gates with gate bootstrapping on the port (GINX).

Counterpart of `examples/boolean.py` (reference:
src/binfhe/examples/boolean.cpp): the four input combinations as one
batched ciphertext. On the GPU unless `--device cpu`:

    python examples_torch/boolean.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from examples_torch import bits, exact  # noqa: E402
from openfhe_tpu_torch.binfhe.constants import BINGATE  # noqa: E402
from openfhe_tpu_torch.binfhe.context import BinFHEContext  # noqa: E402

TRUTH = {BINGATE.AND: [0, 0, 0, 1], BINGATE.OR: [0, 1, 1, 1],
         BINGATE.NAND: [1, 1, 1, 0], BINGATE.XOR: [0, 1, 1, 0]}


def main(device=None, param_set="TOY", seed=0) -> dict:
    """AND, OR, NAND, XOR and NOT on all four input pairs; returns each
    decryption beside its truth table (STD128 is the set for real use)."""
    cc = BinFHEContext(seed, device=device).GenerateBinFHEContext(param_set)
    sk = cc.KeyGen()
    print("generating bootstrapping keys...")
    cc.BTKeyGen(sk)

    m1 = np.array([0, 0, 1, 1], np.uint32)
    m2 = np.array([0, 1, 0, 1], np.uint32)
    ct1 = cc.Encrypt(sk, m1)
    ct2 = cc.Encrypt(sk, m2)

    checks = {}
    for gate, truth in TRUTH.items():
        got = bits(cc.Decrypt(sk, cc.EvalBinGate(gate, ct1, ct2)))
        print(f"{gate.name}(m1, m2) =", got)
        checks[gate.name] = exact(got, truth)
    got = bits(cc.Decrypt(sk, cc.EvalNOT(ct1)))
    print("NOT(m1) =", got)
    checks["NOT"] = exact(got, 1 - m1)
    return {"checks": checks, "n": cc.n, "N": cc.N}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
