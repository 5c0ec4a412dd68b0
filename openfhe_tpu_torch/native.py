"""ctypes bindings for the native host library (`native/fhe_host.cpp`).

Counterpart of `openfhe_tpu/native.py`. The exact CRT work at the host
data boundary (the CKKS decode, residue lifts) and the plaintext-side
NTT of the packed encoding run in C++ with __int128 arithmetic, far
faster than Python integers at large N. The port builds its own copy of
the library from the same source, with the JAX package's flags (`g++
-O3 -march=native -shared -fPIC`: the decode's float sums then round as
the JAX package's, fused multiply-adds included, bit for bit), into
`_build.BUILD_DIR` under a name that carries the digest of the source,
the flags and the host's CPU features, at first use; it never touches `native/libfhe_host.so`, the JAX package's.
A failed build raises: nothing here falls back to Python. The Python
paths stay beside the callers as their plain twins (`math/crt.py`,
`pke/encoding/packed.py`).

All five entry points of the source are bound: `garner_digits`,
`crt_interpolate_centered_double`, `to_residues_i64`, `host_ntt` and
`switch_centered_u64`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

from openfhe_tpu_torch import _build

SOURCE = Path(__file__).resolve().parent.parent / "native" / "fhe_host.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_int, _u64 = ctypes.c_int, ctypes.c_uint64
ENTRIES = {
    "garner_digits": [_u32p, _u64p, _int, _int, _u64p],
    "crt_interpolate_centered_double": [_u32p, _u64p, _int, _int, _f64p],
    "to_residues_i64": [_i64p, _u64p, _int, _int, _u32p],
    "host_ntt": [_u64p, _int, _int, _u64, _u64p, _u64p, _u64, _int],
    "switch_centered_u64": [_u64p, _u64, _u64, _int, _u64p],
}


def _cpu_features() -> bytes:
    """The host's instruction-set features, which `-march=native` builds
    for: a library built on another machine is not reused."""
    try:
        with open("/proc/cpuinfo") as info:
            return next((line for line in info
                         if line.startswith("flags")), "").encode()
    except OSError:
        return platform.machine().encode()


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (once, under the digest of the source, the flags and the
    host's features) and load the library."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha1(src + " ".join(CXX_FLAGS).encode()
                          + _cpu_features()).hexdigest()
    so = Path(_build.BUILD_DIR) / f"libfhe_host-{digest[:12]}.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cxx = shutil.which(CXX) or CXX
        try:
            run = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                                  str(SOURCE)], capture_output=True,
                                 text=True)
        except OSError as err:
            raise RuntimeError(f"cannot run {CXX} to build {SOURCE}: "
                               f"{err}") from err
        if run.returncode:
            raise RuntimeError(f"{CXX} failed to build {SOURCE} (exit "
                               f"{run.returncode}):\n{run.stdout}"
                               f"{run.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def _moduli(moduli) -> np.ndarray:
    mods = np.ascontiguousarray(np.array([int(m) for m in moduli],
                                         np.uint64))
    if not (mods > 1).all() or not (mods < 1 << 32).all():
        raise ValueError("moduli must lie in (1, 2^32)")
    return mods


def _residues(residues: np.ndarray, k: int) -> np.ndarray:
    res = np.ascontiguousarray(residues, np.uint32)
    if res.ndim != 2 or res.shape[0] != k:
        raise ValueError(f"residues of shape {res.shape}: expected "
                         f"[{k}, n]")
    return res


def garner_digits(residues: np.ndarray, moduli) -> np.ndarray:
    """Garner's mixed-radix digits of [k, n] residues: x = d0 + d1 q0 +
    d2 q0 q1 + ..., 0 <= d_i < q_i, as [k, n] uint64."""
    mods = _moduli(moduli)
    res = _residues(residues, len(mods))
    out = np.empty(res.shape, np.uint64)
    load().garner_digits(res, mods, res.shape[0], res.shape[1], out)
    return out


def crt_interpolate_centered_double(residues: np.ndarray,
                                    moduli) -> np.ndarray:
    """Centered CRT value of [k, n] residues as float64 per coefficient
    (the CKKS decode), as the source computes it: the sign from the top
    Garner digit alone, the weights as doubles (so NaN or inf once the
    product of the moduli passes 2^1024)."""
    mods = _moduli(moduli)
    res = _residues(residues, len(mods))
    out = np.empty(res.shape[1], np.float64)
    load().crt_interpolate_centered_double(res, mods, res.shape[0],
                                           res.shape[1], out)
    return out


def to_residues_i64(values: np.ndarray, moduli) -> np.ndarray:
    """Exact residues of signed int64 values: [k, n] uint32."""
    mods = _moduli(moduli)
    if (mods >= 1 << 31).any():
        raise ValueError("to_residues_i64 takes moduli below 2^31")
    vals = np.ascontiguousarray(values, np.int64).reshape(-1)
    out = np.empty((len(mods), len(vals)), np.uint32)
    load().to_residues_i64(vals, mods, len(mods), len(vals), out)
    return out


def host_ntt(x: np.ndarray, q: int, psi_br: np.ndarray, ipsi_br: np.ndarray,
             ninv: int, inverse: bool) -> np.ndarray:
    """Batched negacyclic NTT mod q < 2^32 on the host (the butterflies of
    `pke/encoding/packed._host_ntt`), on a copy: x [..., n] words in
    [0, q) -> uint64 of the same shape."""
    arr = np.ascontiguousarray(x, np.uint64).copy()
    n = arr.shape[-1]
    if n & (n - 1) or len(psi_br) != n or len(ipsi_br) != n:
        raise ValueError(f"host_ntt: n = {n} with tables of "
                         f"{len(psi_br)} / {len(ipsi_br)}")
    if not 1 < q < 1 << 32 or (arr >= q).any():
        raise ValueError(f"host_ntt: words must lie in [0, q), q = {q}")
    load().host_ntt(arr.reshape(-1, n), arr.size // n, n, q,
                    np.ascontiguousarray(psi_br, np.uint64),
                    np.ascontiguousarray(ipsi_br, np.uint64), int(ninv),
                    1 if inverse else 0)
    return arr


def switch_centered_u64(values: np.ndarray, q_from: int,
                        q_to: int) -> np.ndarray:
    """Centered exact modulus switch of words mod q_from < 2^64:
    round(centered(v) * q_to / q_from) mod q_to, as uint64."""
    vals = np.ascontiguousarray(values, np.uint64).reshape(-1)
    if (vals >= q_from).any():
        raise ValueError("switch_centered_u64: words must lie in "
                         "[0, q_from)")
    out = np.empty(len(vals), np.uint64)
    load().switch_centered_u64(vals, q_from, q_to, len(vals), out)
    return out
