"""HomomorphicEncryption.org standard lattice-security tables.

A copy of `openfhe_tpu/lattice/stdlatticeparms.py`. Reference analog:
OpenFHE's src/core/include/lattice/stdlatticeparms.h (:82-137) and
lib/lattice/stdlatticeparms.cpp. The values are the published
HE-standard maximum log2(Q) per (secret distribution, ring dimension,
security level); identical numbers because they are standardized data.
"""

from __future__ import annotations

from openfhe_tpu_torch.pke.constants import SecurityLevel

UNIFORM = "uniform"
ERROR = "error"
TERNARY = "ternary"

# {(dist, level): {ring_dim: max_log_q}}
_C128, _C192, _C256 = (SecurityLevel.HEStd_128_classic,
                       SecurityLevel.HEStd_192_classic,
                       SecurityLevel.HEStd_256_classic)
_Q128, _Q192, _Q256 = (SecurityLevel.HEStd_128_quantum,
                       SecurityLevel.HEStd_192_quantum,
                       SecurityLevel.HEStd_256_quantum)


def _t(pairs):
    return dict(pairs)


MAX_LOG_Q: dict = {
    (UNIFORM, _C128): _t([(1024, 29), (2048, 56), (4096, 111), (8192, 220),
                          (16384, 440), (32768, 880)]),
    (UNIFORM, _C192): _t([(1024, 21), (2048, 39), (4096, 77), (8192, 154),
                          (16384, 307), (32768, 612)]),
    (UNIFORM, _C256): _t([(1024, 16), (2048, 31), (4096, 60), (8192, 120),
                          (16384, 239), (32768, 478)]),
    (UNIFORM, _Q128): _t([(1024, 27), (2048, 53), (4096, 103), (8192, 206),
                          (16384, 413), (32768, 829)]),
    (UNIFORM, _Q192): _t([(1024, 19), (2048, 37), (4096, 72), (8192, 143),
                          (16384, 286), (32768, 573)]),
    (UNIFORM, _Q256): _t([(1024, 15), (2048, 29), (4096, 56), (8192, 111),
                          (16384, 222), (32768, 445)]),
    (ERROR, _C128): _t([(1024, 29), (2048, 56), (4096, 111), (8192, 220),
                        (16384, 440), (32768, 883), (65536, 1749),
                        (131072, 3525)]),
    (ERROR, _C192): _t([(1024, 21), (2048, 39), (4096, 77), (8192, 154),
                        (16384, 307), (32768, 613), (65536, 1201),
                        (131072, 2413)]),
    (ERROR, _C256): _t([(1024, 16), (2048, 31), (4096, 60), (8192, 120),
                        (16384, 239), (32768, 478), (65536, 931),
                        (131072, 1868)]),
    (ERROR, _Q128): _t([(1024, 27), (2048, 53), (4096, 103), (8192, 206),
                        (16384, 413), (32768, 829), (65536, 1665),
                        (131072, 3351)]),
    (ERROR, _Q192): _t([(1024, 19), (2048, 37), (4096, 72), (8192, 143),
                        (16384, 286), (32768, 573), (65536, 1147),
                        (131072, 2304)]),
    (ERROR, _Q256): _t([(1024, 15), (2048, 29), (4096, 56), (8192, 111),
                        (16384, 222), (32768, 445), (65536, 890),
                        (131072, 1786)]),
    (TERNARY, _C128): _t([(1024, 27), (2048, 54), (4096, 109), (8192, 218),
                          (16384, 438), (32768, 881), (65536, 1747),
                          (131072, 3523)]),
    (TERNARY, _C192): _t([(1024, 19), (2048, 37), (4096, 75), (8192, 152),
                          (16384, 305), (32768, 611), (65536, 1199),
                          (131072, 2411)]),
    (TERNARY, _C256): _t([(1024, 14), (2048, 29), (4096, 58), (8192, 118),
                          (16384, 237), (32768, 476), (65536, 929),
                          (131072, 1866)]),
    (TERNARY, _Q128): _t([(1024, 25), (2048, 51), (4096, 101), (8192, 202),
                          (16384, 411), (32768, 827), (65536, 1663),
                          (131072, 3348)]),
    (TERNARY, _Q192): _t([(1024, 17), (2048, 35), (4096, 70), (8192, 141),
                          (16384, 284), (32768, 571), (65536, 1145),
                          (131072, 2301)]),
    (TERNARY, _Q256): _t([(1024, 13), (2048, 27), (4096, 54), (8192, 109),
                          (16384, 220), (32768, 443), (65536, 888),
                          (131072, 1784)]),
}


def find_max_q(dist: str, level: SecurityLevel, ring_dim: int) -> int:
    """Max log2(Q) for the given (distribution, level, N); 0 if unlisted."""
    return MAX_LOG_Q.get((dist, level), {}).get(ring_dim, 0)


def find_ring_dim(dist: str, level: SecurityLevel, log_q: int) -> int:
    """Smallest standardized N whose max log Q accommodates `log_q`."""
    table = MAX_LOG_Q.get((dist, level), {})
    for n in sorted(table):
        if log_q <= table[n]:
            return n
    raise ValueError(
        f"logQ={log_q} exceeds standardized parameters for {dist}/{level}; "
        f"use SecurityLevel.HEStd_NotSet for experimental sizes")


def validate(dist: str, level: SecurityLevel, ring_dim: int,
             log_q: int) -> None:
    if level == SecurityLevel.HEStd_NotSet:
        return
    max_q = find_max_q(dist, level, ring_dim)
    if max_q == 0:
        raise ValueError(f"no standardized entry for N={ring_dim} at {level}")
    if log_q > max_q:
        raise ValueError(
            f"logQ={log_q} > standardized max {max_q} for N={ring_dim}, "
            f"{dist}, {level}")
