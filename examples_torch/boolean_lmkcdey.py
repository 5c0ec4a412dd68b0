"""FHEW Boolean gates with the LMKCDEY bootstrapping method on the port.

Counterpart of `examples/boolean_lmkcdey.py` (reference:
src/binfhe/examples/boolean-lmkcdey.cpp): the automorphism-ladder blind
rotation on a custom ring, or on a named set (`param_set`, e.g.
STD128_LMKCDEY). On the GPU unless `--device cpu`:

    python examples_torch/boolean_lmkcdey.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from examples_torch import bits, exact  # noqa: E402
from openfhe_tpu_torch.binfhe.constants import (BINFHE_METHOD,  # noqa: E402
                                                BINGATE)
from openfhe_tpu_torch.binfhe.context import BinFHEContext  # noqa: E402


def main(device=None, param_set=None, n=64, N=1024, q=2048, q_bits=27,
         base_ks=25, base_g=128, num_auto_keys=10, seed=0) -> dict:
    """AND and XOR on all four input pairs; returns each decryption
    beside its truth table. `param_set` names a set in place of the
    custom ring."""
    cc = BinFHEContext(seed, device=device)
    if param_set is None:
        cc.GenerateBinFHEContextCustom(
            n=n, N=N, q=q, q_bits=q_bits, base_ks=base_ks, base_g=base_g,
            method=BINFHE_METHOD.LMKCDEY, num_auto_keys=num_auto_keys)
    else:
        cc.GenerateBinFHEContext(param_set, method=BINFHE_METHOD.LMKCDEY)
    sk = cc.KeyGen()
    cc.BTKeyGen(sk)

    a = cc.Encrypt(sk, np.array([0, 0, 1, 1]))
    b = cc.Encrypt(sk, np.array([0, 1, 0, 1]))
    checks = {}
    for gate, truth in ((BINGATE.AND, [0, 0, 0, 1]),
                        (BINGATE.XOR, [0, 1, 1, 0])):
        got = bits(cc.Decrypt(sk, cc.EvalBinGate(gate, a, b)))
        print(f"{gate.name}:", got)
        assert got == truth
        checks[gate.name] = exact(got, truth)
    print("OK (LMKCDEY method)")
    return {"checks": checks, "n": cc.n, "N": cc.N}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
