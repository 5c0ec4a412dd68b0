"""Small configurations and mixes of the benchmark's cells for the CPU."""

from openfhe_tpu_torch.math import nbtheory
from openfhe_tpu_torch.pke import parameters as prm


def ckks(n=1024, depth=6, aux_bits=27):
    """CKKS at ring n and `depth` with 3 digits, moduli as the port picks
    them (26/27-bit Q, `aux_bits`-bit P)."""
    mq = prm.select_ckks_moduli(n, depth, 26, 27, flexible=False)
    mp = prm.select_aux_moduli(n, mq, 3, aux_bits)
    return {"system": "ckks",
            "params": {"scheme": "CKKSRNS_SCHEME", "ring_dim": n,
                       "mult_depth": depth, "scaling_mod_size": 26,
                       "first_mod_size": 27, "aux_mod_size": aux_bits,
                       "num_large_digits": 3,
                       "security_level": "HEStd_NotSet",
                       "scaling_technique": "FIXEDMANUAL"},
            "moduli_q": mq, "moduli_p": mp}


def toy():
    """BinFHE's TOY set (n 64, N 512, q 512, q_KS = Q) with GINX."""
    big_q = nbtheory.previous_prime(1 << 27, 1024)
    return {"system": "binfhe", "param_set": "TOY", "method": "GINX",
            "n": 64, "ring_dim": 512, "q": 512, "Q": big_q, "q_ks": big_q,
            "base_ks": 25, "base_g": 512}


MULT = {"request": "mult_rescale", "clients": 4, "levels": [0, 2, 4],
        "pool": 2, "operands": 2, "sample": 3}
HOISTED = {"request": "hoisted_linear", "clients": 2, "levels": [0, 3],
           "pool": 2, "operands": 1, "rotations": 3, "sample": 2}
AND = {"request": "gate", "clients": 2, "gates": ["AND"], "batch": 8,
       "pool": 64, "operands": 2, "sample": 2}
CHAIN = {"request": "gate", "clients": 1,
         "gates": ["AND", "OR", "NAND", "NOR"], "batch": 1, "pool": 64,
         "operands": 2, "chain": True, "sample": 4}
CELLS = {"mult": (ckks, MULT), "hoisted": (ckks, HOISTED), "and": (toy, AND),
         "chain": (toy, CHAIN)}
