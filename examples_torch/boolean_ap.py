"""FHEW Boolean gates with the AP (DM) bootstrapping method on the port.

Counterpart of `examples/boolean_ap.py` (reference:
src/binfhe/examples/boolean-ap.cpp), on the GPU unless `--device cpu`:

    python examples_torch/boolean_ap.py [--device cpu]
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


def main(device=None, param_set="TOY", seed=0) -> dict:
    """AND, OR, NAND on all four input pairs under AP; returns each
    decryption beside its truth table (STD128_AP for real use)."""
    cc = BinFHEContext(seed, device=device)
    cc.GenerateBinFHEContext(param_set, method="AP")
    sk = cc.KeyGen()
    cc.BTKeyGen(sk)

    # all four input combinations at once (batched ciphertexts)
    a = cc.Encrypt(sk, np.array([0, 0, 1, 1]))
    b = cc.Encrypt(sk, np.array([0, 1, 0, 1]))
    checks = {}
    for gate, truth in ((BINGATE.AND, [0, 0, 0, 1]),
                        (BINGATE.OR, [0, 1, 1, 1]),
                        (BINGATE.NAND, [1, 1, 1, 0])):
        got = bits(cc.Decrypt(sk, cc.EvalBinGate(gate, a, b)))
        print(f"{gate.name}: {got}")
        assert got == truth
        checks[gate.name] = exact(got, truth)
    print("OK (AP method)")
    return {"checks": checks, "n": cc.n, "N": cc.N}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
