"""Arbitrary functions over Z_p by FHEW functional bootstrapping (port).

Counterpart of `examples/eval_function_binfhe.py` (reference:
src/binfhe/examples/eval-function.cpp), on the GPU unless
`--device cpu`:

    python examples_torch/eval_function_binfhe.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from examples_torch import bits, exact  # noqa: E402
from openfhe_tpu_torch.binfhe.context import BinFHEContext  # noqa: E402


def main(device=None, n=64, N=1024, q=1024, q_bits=27, base_ks=25,
         base_g=512, seed=0, p=4) -> dict:
    """f(x) = x^2 mod 4 on the batch 0 ... 3; returns the decryption
    beside what it should be."""
    cc = BinFHEContext(seed, device=device).GenerateBinFHEContextCustom(
        n=n, N=N, q=q, q_bits=q_bits, base_ks=base_ks, base_g=base_g)
    sk = cc.KeyGen()
    print("generating bootstrapping keys...")
    cc.BTKeyGen(sk)

    lut = cc.GenerateLUTviaFunction(lambda m, pp: (m * m) % pp, p)
    msgs = np.arange(p, dtype=np.uint32)
    ct = cc.Encrypt(sk, msgs, p=p)
    got = bits(cc.Decrypt(sk, cc.EvalFunc(ct, lut), p=p))
    want = (np.arange(p) ** 2) % p
    print(f"f(x) = x^2 mod {p}:", got, "expected:", want)
    return {"checks": {"x^2 mod p": exact(got, want)}}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
