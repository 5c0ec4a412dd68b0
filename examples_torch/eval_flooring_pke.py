"""Homomorphic flooring of a public-key encryption on the port (FHEW).

Counterpart of `examples/eval_flooring_pke.py` (reference:
src/binfhe/examples/pke/eval-flooring-pke.cpp), on the GPU unless
`--device cpu`:

    python examples_torch/eval_flooring_pke.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from examples_torch import exact, one  # noqa: E402
from openfhe_tpu_torch.binfhe.constants import KEYGEN_MODE  # noqa: E402
from openfhe_tpu_torch.binfhe.context import BinFHEContext  # noqa: E402


def main(device=None, n=64, N=1024, q=1024, q_bits=27, base_ks=25,
         base_g=512, seed=0, m=13, p_large=16, round_bits=2) -> dict:
    """floor(13 >> 2) of a public-key encryption at p = 16; returns the
    decryption beside what it should be."""
    cc = BinFHEContext(seed, device=device).GenerateBinFHEContextCustom(
        n=n, N=N, q=q, q_bits=q_bits, base_ks=base_ks, base_g=base_g)
    sk = cc.KeyGen()
    print("generating bootstrapping keys...")
    cc.BTKeyGen(sk, keygen_mode=KEYGEN_MODE.PUB_ENCRYPT)
    pk = cc.GetPublicKey()

    q_large = cc.q * (p_large // 4)
    # pk encryption lands at (N, Q) and is switched to (n, q_large)
    ct = cc.Encrypt(pk, m, p=p_large, q=q_large)
    fl = cc.EvalFloor(ct, round_bits)
    got = one(cc.Decrypt(sk, fl, p=p_large >> round_bits))
    print(f"floor({m} >> {round_bits}) = {got} (expected {m >> round_bits})")
    assert got == m >> round_bits
    print("OK")
    return {"checks": {"floor": exact(got, m >> round_bits)}}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
