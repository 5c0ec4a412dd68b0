"""FHEW Boolean gates over public-key encryptions on the port.

Counterpart of `examples/boolean_pke.py` (reference:
src/binfhe/examples/pke/boolean-pke.cpp): LWE public-key encryption at
(N, Q), switched down to (n, q) for the gates. On the GPU unless
`--device cpu`:

    python examples_torch/boolean_pke.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from examples_torch import exact, one  # noqa: E402
from openfhe_tpu_torch.binfhe.constants import (BINGATE,  # noqa: E402
                                                KEYGEN_MODE)
from openfhe_tpu_torch.binfhe.context import BinFHEContext  # noqa: E402


def main(device=None, param_set="TOY", seed=0) -> dict:
    """A LARGE_DIM round trip, then gates on SMALL_DIM public-key
    encryptions; returns each decryption beside what it should be
    (STD128 is the set for real use)."""
    cc = BinFHEContext(seed, device=device).GenerateBinFHEContext(param_set)

    # public-key encrypt / decrypt without a bootstrap (LARGE_DIM)
    pk0, sk_n = cc.KeyGenPair()
    large = one(cc.Decrypt(sk_n, cc.Encrypt(pk0, 1, output="LARGE_DIM")))
    print("pk-encrypted 1 decrypts to", large)
    assert large == 1

    # the gate path: small secret, bootstrapping keys and the stored pk
    sk = cc.KeyGen()
    print("generating bootstrapping keys...")
    cc.BTKeyGen(sk, keygen_mode=KEYGEN_MODE.PUB_ENCRYPT)
    pk = cc.GetPublicKey()
    ct1 = cc.Encrypt(pk, 1)
    ct2 = cc.Encrypt(pk, 1)
    small = one(cc.Decrypt(sk, ct1))
    print("pk-encrypted (SMALL_DIM) 1 decrypts to", small)
    assert small == 1

    ct_and1 = cc.EvalBinGate(BINGATE.AND, ct1, ct2)
    r1 = one(cc.Decrypt(sk, ct_and1))
    print("1 AND 1 =", r1)
    assert r1 == 1
    ct_and2 = cc.EvalBinGate(BINGATE.AND, cc.EvalNOT(ct2), ct1)
    r2 = one(cc.Decrypt(sk, ct_and2))
    print("(NOT 1) AND 1 =", r2)
    assert r2 == 0
    r3 = one(cc.Decrypt(sk, cc.EvalBinGate(BINGATE.OR, ct_and1, ct_and2)))
    print("(1 AND 1) OR ((NOT 1) AND 1) =", r3)
    assert r3 == 1
    print("OK")
    return {"checks": {"LARGE_DIM 1": exact(large, 1),
                       "SMALL_DIM 1": exact(small, 1),
                       "1 AND 1": exact(r1, 1),
                       "(NOT 1) AND 1": exact(r2, 0),
                       "OR of both": exact(r3, 1)},
            "n": cc.n, "N": cc.N}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
