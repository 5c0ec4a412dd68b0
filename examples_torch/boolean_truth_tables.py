"""Full truth tables of the two-input gates on the port.

Counterpart of `examples/boolean_truth_tables.py` (reference:
src/binfhe/examples/boolean-truth-tables.cpp): every gate on the four
input pairs in one batch. On the GPU unless `--device cpu`:

    python examples_torch/boolean_truth_tables.py [--device cpu]
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

TABLES = {
    BINGATE.AND: [0, 0, 0, 1], BINGATE.OR: [0, 1, 1, 1],
    BINGATE.NAND: [1, 1, 1, 0], BINGATE.NOR: [1, 0, 0, 0],
    BINGATE.XOR: [0, 1, 1, 0], BINGATE.XNOR: [1, 0, 0, 1],
}


def main(device=None, param_set="TOY", seed=0) -> dict:
    """Six gates and NOT; returns each decryption beside its table."""
    cc = BinFHEContext(seed, device=device)
    cc.GenerateBinFHEContext(param_set)
    sk = cc.KeyGen()
    cc.BTKeyGen(sk)

    a = cc.Encrypt(sk, np.array([0, 0, 1, 1]))
    b = cc.Encrypt(sk, np.array([0, 1, 0, 1]))
    print("a b |", "  ".join(g.name for g in TABLES))
    checks = {}
    for gate, truth in TABLES.items():
        got = bits(cc.Decrypt(sk, cc.EvalBinGate(gate, a, b)))
        print(f"{gate.name:5s} {got}")
        assert got == truth, (gate, got, truth)
        checks[gate.name] = exact(got, truth)
    got = bits(cc.Decrypt(sk, cc.EvalNOT(a)))
    assert got == [1, 1, 0, 0]
    checks["NOT"] = exact(got, [1, 1, 0, 0])
    print("OK")
    return {"checks": checks, "n": cc.n, "N": cc.N}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
