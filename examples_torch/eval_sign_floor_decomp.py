"""Large-precision sign, floor and digit decomposition on the port (FHEW).

Counterpart of `examples/eval_sign_floor_decomp.py` (reference:
src/binfhe/examples/eval-sign.cpp, eval-flooring.cpp, eval-decomp.cpp):
iterated functional bootstraps on p = 16 ciphertexts. On the GPU unless
`--device cpu`:

    python examples_torch/eval_sign_floor_decomp.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from examples_torch import exact, one  # noqa: E402
from openfhe_tpu_torch.binfhe.context import BinFHEContext  # noqa: E402


def main(device=None, n=64, N=1024, q=1024, q_bits=27, base_ks=25,
         base_g=512, seed=0, p_large=16) -> dict:
    """EvalSign of 2 and 13, EvalFloor of 13 by 2 bits and the base-4
    digits of 11; returns each decryption beside what it should be."""
    cc = BinFHEContext(seed, device=device).GenerateBinFHEContextCustom(
        n=n, N=N, q=q, q_bits=q_bits, base_ks=base_ks, base_g=base_g)
    sk = cc.KeyGen()
    cc.BTKeyGen(sk)
    q_large = cc.q * (p_large // 4)
    checks = {}

    # EvalSign: the top bit of values around q/2
    for m in (2, 13):
        s = cc.EvalSign(cc.Encrypt(sk, m, p=p_large, q=q_large))
        got = one(cc.Decrypt(sk, s, p=2))
        want = 1 if m >= p_large // 2 else 0
        print(f"sign({m} of {p_large}) -> {got}")
        assert got == want
        checks[f"sign({m})"] = exact(got, want)

    # EvalFloor: drop the lowest bits
    m = 13
    fl = cc.EvalFloor(cc.Encrypt(sk, m, p=p_large, q=q_large), 2)
    got = one(cc.Decrypt(sk, fl, p=p_large >> 2))
    print(f"floor({m} >> 2) -> {got}")
    assert got == m >> 2
    checks["floor(13 >> 2)"] = exact(got, m >> 2)

    # EvalDecomp: base-4 digits
    m = 11
    digits = cc.EvalDecomp(cc.Encrypt(sk, m, p=p_large, q=q_large))
    vals = [one(cc.Decrypt(sk, d, p=4)) for d in digits]
    rec = sum(v * (4 ** i) for i, v in enumerate(vals))
    print(f"decomp({m}) -> digits {vals} -> {rec}")
    assert rec == m
    checks["decomp(11)"] = exact(rec, m)
    print("OK")
    return {"checks": checks}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
