"""Full Boolean truth tables over public-key encryptions on the port.

Counterpart of `examples/boolean_truth_tables_pke.py` (reference:
src/binfhe/examples/pke/boolean-truth-tables-pke.cpp): the four input
pairs as one batched ciphertext. On the GPU unless `--device cpu`:

    python examples_torch/boolean_truth_tables_pke.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from examples_torch import bits, exact  # noqa: E402
from openfhe_tpu_torch.binfhe.constants import (BINGATE,  # noqa: E402
                                                KEYGEN_MODE)
from openfhe_tpu_torch.binfhe.context import BinFHEContext  # noqa: E402

EXPECTED = {
    BINGATE.AND: [0, 0, 0, 1], BINGATE.OR: [0, 1, 1, 1],
    BINGATE.NAND: [1, 1, 1, 0], BINGATE.NOR: [1, 0, 0, 0],
    BINGATE.XOR: [0, 1, 1, 0], BINGATE.XNOR: [1, 0, 0, 1],
}


def main(device=None, param_set="TOY", seed=0) -> dict:
    """Six gates on public-key encryptions; returns each decryption
    beside its table."""
    cc = BinFHEContext(seed, device=device).GenerateBinFHEContext(param_set)
    sk = cc.KeyGen()
    print("generating bootstrapping keys...")
    cc.BTKeyGen(sk, keygen_mode=KEYGEN_MODE.PUB_ENCRYPT)
    pk = cc.GetPublicKey()

    a = np.array([0, 0, 1, 1], np.uint32)
    b = np.array([0, 1, 0, 1], np.uint32)
    ct_a = cc.Encrypt(pk, a)
    ct_b = cc.Encrypt(pk, b)
    checks = {}
    for gate, want in EXPECTED.items():
        got = bits(cc.Decrypt(sk, cc.EvalBinGate(gate, ct_a, ct_b)))
        print(f"{gate.name}: {got}")
        assert got == want, (gate, got, want)
        checks[gate.name] = exact(got, want)
    print("OK")
    return {"checks": checks}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
