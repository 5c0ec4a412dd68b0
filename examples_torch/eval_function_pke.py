"""A lookup-table bootstrap of public-key encryptions on the port (FHEW).

Counterpart of `examples/eval_function_pke.py` (reference:
src/binfhe/examples/pke/eval-function-pke.cpp): f(x) = x^3 mod p through
GenerateLUTviaFunction + EvalFunc, q = N so p = 8. On the GPU unless
`--device cpu`:

    python examples_torch/eval_function_pke.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from examples_torch import exact, one  # noqa: E402
from openfhe_tpu_torch.binfhe.constants import KEYGEN_MODE  # noqa: E402
from openfhe_tpu_torch.binfhe.context import BinFHEContext  # noqa: E402


def main(device=None, n=64, N=2048, q=2048, q_bits=27, base_ks=25,
         base_g=512, seed=0) -> dict:
    """x^3 mod 8 of each of 0 ... 7, encrypted under the public key;
    returns the decryptions beside what they should be."""
    cc = BinFHEContext(seed, device=device).GenerateBinFHEContextCustom(
        n=n, N=N, q=q, q_bits=q_bits, base_ks=base_ks, base_g=base_g)
    sk = cc.KeyGen()
    print("generating bootstrapping keys...")
    cc.BTKeyGen(sk, keygen_mode=KEYGEN_MODE.PUB_ENCRYPT)
    pk = cc.GetPublicKey()

    p = cc.GetMaxPlaintextSpace()
    assert p == 8
    lut = cc.GenerateLUTviaFunction(lambda x, pp: (x * x * x) % pp, p)
    print(f"evaluating x^3 mod {p}")
    got = []
    for i in range(p):
        ct_cube = cc.EvalFunc(cc.Encrypt(pk, i, p=p), lut)
        got.append(one(cc.Decrypt(sk, ct_cube, p=p)))
        print(f"  input {i}: expected {(i ** 3) % p}, evaluated {got[-1]}")
        assert got[-1] == (i ** 3) % p
    print("OK")
    return {"checks": {"x^3 mod p": exact(got,
                                          [(i ** 3) % p for i in range(p)])}}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
