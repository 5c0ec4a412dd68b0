"""BinFHE enums and parameter sets.

Counterpart of `openfhe_tpu/binfhe/constants.py`, copied. Reference
analog: OpenFHE's src/binfhe/include/binfhe-constants.h
(BINFHE_PARAMSET :49-89, BINGATE, BINFHE_METHOD) and the parameter table in
src/binfhe/lib/binfhecontext.cpp:113-161. The table values are the published
HE-standard parameter sets (public constants).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from openfhe_tpu_torch.pke.constants import SecretKeyDist


class BINFHE_METHOD(enum.Enum):
    AP = "AP"            # DM/FHEW base-decomposed blind rotation
    GINX = "GINX"        # CGGI/TFHE CMUX blind rotation
    LMKCDEY = "LMKCDEY"  # automorphism-based blind rotation


class BINGATE(enum.IntEnum):
    """(binfhe-constants.h; order matches the gate-constant table)"""
    OR = 0
    AND = 1
    NOR = 2
    NAND = 3
    XOR = 4
    XNOR = 5
    MAJORITY = 6
    AND3 = 7
    OR3 = 8
    AND4 = 9
    OR4 = 10
    XOR_FAST = 11
    XNOR_FAST = 12
    CMUX = 13     # composed from NANDs (no gate constant)


class BINFHE_OUTPUT(enum.Enum):
    FRESH = "FRESH"
    BOOTSTRAPPED = "BOOTSTRAPPED"


class KEYGEN_MODE(enum.Enum):
    SYM_ENCRYPT = "SYM_ENCRYPT"
    PUB_ENCRYPT = "PUB_ENCRYPT"


PRIME = 0   # modKS sentinel: use the RLWE modulus Q for key switching


@dataclass(frozen=True)
class BinFHEContextParams:
    """One row of the paramset table (binfhecontext.cpp:113)."""
    number_bits: int        # log2(Q) for the RLWE modulus
    cyc_order: int          # 2N
    lattice_param: int      # n (LWE dimension)
    mod: int                # q (LWE ciphertext modulus)
    mod_ks: int             # qKS (key-switch modulus; PRIME = use Q)
    base_ks: int            # Bks
    base_g: int             # Bg (gadget base)
    base_rk: int            # Brk (AP refresh base)
    num_auto_keys: int      # LMKCDEY window
    key_dist: SecretKeyDist = SecretKeyDist.UNIFORM_TERNARY
    std_dev: float = 3.19


U = SecretKeyDist.UNIFORM_TERNARY
G = SecretKeyDist.GAUSSIAN

# (binfhecontext.cpp:113-161)
PARAM_SETS: dict = {
    "TOY":                 BinFHEContextParams(27, 1024, 64, 512, PRIME, 25, 512, 23, 9, U),
    "MEDIUM":              BinFHEContextParams(28, 2048, 422, 1024, 16384, 128, 1024, 32, 10, U),
    "STD128_AP":           BinFHEContextParams(27, 2048, 559, 2048, 32768, 32, 512, 64, 10, U),
    "STD128":              BinFHEContextParams(27, 2048, 556, 2048, 32768, 32, 128, 64, 10, U),
    "STD128_3":            BinFHEContextParams(27, 2048, 595, 2048, 65536, 64, 128, 64, 10, U),
    "STD128_4":            BinFHEContextParams(27, 2048, 635, 2048, 131072, 64, 32, 64, 10, U),
    "STD128Q":             BinFHEContextParams(25, 2048, 601, 2048, 32768, 32, 16, 64, 10, U),
    "STD128Q_3":           BinFHEContextParams(25, 2048, 641, 2048, 65536, 64, 16, 64, 10, U),
    "STD128Q_4":           BinFHEContextParams(50, 4096, 683, 4096, 131072, 64, 131072, 64, 10, U),
    "STD192":              BinFHEContextParams(37, 4096, 821, 2048, 32768, 32, 8192, 64, 10, U),
    "STD192_3":            BinFHEContextParams(37, 4096, 876, 2048, 65536, 64, 8192, 64, 10, U),
    "STD192_4":            BinFHEContextParams(37, 4096, 932, 4096, 131072, 64, 8192, 64, 10, U),
    "STD192Q":             BinFHEContextParams(34, 4096, 890, 2048, 32768, 32, 4096, 64, 10, U),
    "STD192Q_3":           BinFHEContextParams(34, 4096, 948, 2048, 65536, 64, 4096, 64, 10, U),
    "STD192Q_4":           BinFHEContextParams(34, 4096, 1009, 4096, 131072, 64, 4096, 64, 10, U),
    "STD256":              BinFHEContextParams(29, 4096, 1299, 2048, 262144, 64, 1024, 64, 10, U),
    "STD256_3":            BinFHEContextParams(29, 4096, 1241, 2048, 131072, 64, 256, 64, 10, U),
    "STD256_4":            BinFHEContextParams(29, 4096, 1218, 4096, 131072, 64, 32, 64, 10, U),
    "STD256Q":             BinFHEContextParams(26, 4096, 1242, 2048, 65536, 64, 64, 64, 10, U),
    "STD256Q_3":           BinFHEContextParams(26, 4096, 1319, 4096, 131072, 64, 32, 64, 10, U),
    "STD256Q_4":           BinFHEContextParams(26, 4096, 1319, 4096, 131072, 64, 16, 64, 10, U),
    "STD128_LMKCDEY":      BinFHEContextParams(27, 2048, 581, 1024, 32768, 32, 512, 32, 10, U),
    "STD128_3_LMKCDEY":    BinFHEContextParams(27, 2048, 595, 2048, 65536, 64, 128, 64, 10, U),
    "STD128_4_LMKCDEY":    BinFHEContextParams(27, 2048, 635, 2048, 131072, 64, 64, 64, 10, U),
    "STD128Q_LMKCDEY":     BinFHEContextParams(25, 2048, 640, 1024, 32768, 32, 128, 32, 10, U),
    "STD128Q_3_LMKCDEY":   BinFHEContextParams(25, 2048, 641, 2048, 65536, 64, 16, 64, 10, U),
    "STD128Q_4_LMKCDEY":   BinFHEContextParams(25, 2048, 685, 2048, 131072, 64, 16, 64, 10, U),
    "STD192_LMKCDEY":      BinFHEContextParams(39, 4096, 716, 4096, 32768, 32, 1048576, 64, 10, G),
    "STD192_3_LMKCDEY":    BinFHEContextParams(37, 4096, 876, 2048, 65536, 64, 1024, 64, 10, U),
    "STD192_4_LMKCDEY":    BinFHEContextParams(37, 4096, 932, 4096, 131072, 64, 1024, 64, 10, U),
    "STD192Q_LMKCDEY":     BinFHEContextParams(36, 4096, 778, 4096, 32768, 32, 4096, 64, 10, G),
    "STD192Q_3_LMKCDEY":   BinFHEContextParams(34, 4096, 948, 2048, 65536, 64, 4096, 64, 10, U),
    "STD192Q_4_LMKCDEY":   BinFHEContextParams(34, 4096, 1009, 4096, 131072, 64, 4096, 64, 10, U),
    "STD256_LMKCDEY":      BinFHEContextParams(29, 4096, 1079, 2048, 32768, 32, 1024, 64, 10, U),
    "STD256_3_LMKCDEY":    BinFHEContextParams(29, 4096, 1218, 2048, 131072, 64, 256, 64, 10, U),
    "STD256_4_LMKCDEY":    BinFHEContextParams(29, 4096, 1218, 4096, 131072, 64, 256, 64, 10, U),
    "STD256Q_LMKCDEY":     BinFHEContextParams(26, 4096, 1242, 2048, 65536, 64, 128, 64, 10, U),
    "STD256Q_3_LMKCDEY":   BinFHEContextParams(26, 4096, 1319, 4096, 131072, 64, 64, 64, 10, U),
    "STD256Q_4_LMKCDEY":   BinFHEContextParams(26, 4096, 1319, 4096, 131072, 64, 32, 64, 10, U),
    "LPF_STD128":          BinFHEContextParams(27, 2048, 556, 2048, 32768, 32, 128, 64, 10, U),
    "LPF_STD128Q":         BinFHEContextParams(25, 2048, 601, 2048, 32768, 32, 16, 64, 10, U),
    "LPF_STD128_LMKCDEY":  BinFHEContextParams(27, 2048, 556, 2048, 32768, 32, 128, 64, 10, U),
    "LPF_STD128Q_LMKCDEY": BinFHEContextParams(25, 2048, 601, 2048, 32768, 32, 16, 64, 10, U),
    "SIGNED_MOD_TEST":     BinFHEContextParams(28, 2048, 512, 1024, PRIME, 25, 128, 23, 10, U),
}


def gate_constants(q: int) -> list:
    """Gate-dependent test-vector offsets (rgsw-cryptoparameters.cpp:78)."""
    return [
        5 * (q >> 3),    # OR
        7 * (q >> 3),    # AND
        1 * (q >> 3),    # NOR
        3 * (q >> 3),    # NAND
        6 * (q >> 3),    # XOR
        2 * (q >> 3),    # XNOR
        7 * (q >> 3),    # MAJORITY
        11 * (q // 12),  # AND3
        7 * (q // 12),   # OR3
        15 * (q >> 4),   # AND4
        9 * (q >> 4),    # OR4
        6 * (q >> 3),    # XOR_FAST
        2 * (q >> 3),    # XNOR_FAST
    ]
