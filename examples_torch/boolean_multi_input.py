"""Multi-input Boolean gates on the port: AND3, OR3, MAJORITY, CMUX.

Counterpart of `examples/boolean_multi_input.py` (reference:
src/binfhe/examples/boolean-multi-input.cpp), on the GPU unless
`--device cpu`:

    python examples_torch/boolean_multi_input.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from examples_torch import exact, one  # noqa: E402
from openfhe_tpu_torch.binfhe.constants import BINGATE  # noqa: E402
from openfhe_tpu_torch.binfhe.context import BinFHEContext  # noqa: E402


def main(device=None, param_set="TOY", seed=0) -> dict:
    """AND3, OR3 and MAJORITY of (1, 1, 0) and CMUX(0, 1; sel = 1);
    returns each decryption beside what it should be."""
    cc = BinFHEContext(seed, device=device)
    cc.GenerateBinFHEContext(param_set)
    sk = cc.KeyGen()
    cc.BTKeyGen(sk)

    bits_in = [1, 1, 0]
    cts = [cc.Encrypt(sk, b, p=6) for b in bits_in]
    and3 = one(cc.Decrypt(sk, cc.EvalBinGate(BINGATE.AND3, cts)))
    or3 = one(cc.Decrypt(sk, cc.EvalBinGate(BINGATE.OR3, cts)))
    maj = one(cc.Decrypt(sk, cc.EvalBinGate(
        BINGATE.MAJORITY, [cc.Encrypt(sk, b) for b in bits_in])))
    print("AND3:", and3)
    print("OR3 :", or3)
    print("MAJ :", maj)
    assert and3 == 0
    assert or3 == 1
    assert maj == 1

    sel = cc.Encrypt(sk, 1)
    c0 = cc.Encrypt(sk, 0)
    c1 = cc.Encrypt(sk, 1)
    mux = one(cc.Decrypt(sk, cc.EvalBinGate(BINGATE.CMUX, [c0, c1, sel])))
    print("CMUX(sel=1):", mux)
    assert mux == 1
    print("OK")
    return {"checks": {"AND3": exact(and3, 0), "OR3": exact(or3, 1),
                       "MAJORITY": exact(maj, 1), "CMUX": exact(mux, 1)}}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
