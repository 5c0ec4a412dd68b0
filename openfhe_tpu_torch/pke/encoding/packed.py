"""Packed (integer SIMD) encoding for BGV/BFV.

Counterpart of `openfhe_tpu/pke/encoding/packed.py`, a copy on the host
(numpy and Python ints), like the rest of the port's data boundary.
Reference analog: OpenFHE's src/pke/lib/encoding/packedencoding.cpp
(:51-284): CRT packing of Z_t[X]/(X^N+1) into N slots via a plaintext-side
negacyclic NTT mod t (t prime, t = 1 mod 2N).

Slot layout matches the CKKS convention (encoding/ckks_packed.py): the slot
axis is the orbit of the generator 5 in Z_2N^*; row 0 holds slots at
exponents 5^j, row 1 at exponents -5^j (N/2 each). EvalAtIndex(r) rotates
row 0 (and row 1) cyclically by r, exactly like CKKS rotations.

All host-side (numpy uint64, exact): encoding happens once per plaintext at
the data boundary, like the reference. The exact host NTT mod t is numpy
only (the JAX package may call its optional C++ helper for it; the words
are the same).
"""

from __future__ import annotations

import functools

import numpy as np

from openfhe_tpu_torch.lattice.basis import _bitrev_indices
from openfhe_tpu_torch.math import nbtheory


@functools.lru_cache(maxsize=None)
def _host_tables(t: int, n: int):
    """Twiddles (bit-reversed psi powers) + slot index maps mod t."""
    psi = nbtheory.root_of_unity(2 * n, t)
    ipsi = nbtheory.mod_inverse(psi, t)
    rev = _bitrev_indices(n)
    pows = np.ones(n, np.uint64)
    ipows = np.ones(n, np.uint64)
    for i in range(1, n):
        pows[i] = pows[i - 1] * psi % t
        ipows[i] = ipows[i - 1] * ipsi % t
    psi_br = pows[rev]
    ipsi_br = ipows[rev]
    ninv = nbtheory.mod_inverse(n, t)
    # slot index maps: stored eval index j holds exponent e(j)=2*brv(j)+1;
    # slot (row, i) lives at exponent +-5^i
    two_n = 2 * n
    inv_rev = np.argsort(rev)
    e = 1
    row0 = np.zeros(n // 2, np.int64)
    row1 = np.zeros(n // 2, np.int64)
    for i in range(n // 2):
        row0[i] = inv_rev[(e - 1) // 2]
        row1[i] = inv_rev[(two_n - e - 1) // 2]
        e = e * 5 % two_n
    return psi_br, ipsi_br, ninv, row0, row1


def _host_ntt(a: np.ndarray, t: int, n: int, inverse: bool) -> np.ndarray:
    """Exact negacyclic NTT mod t (the algorithm of ops/ntt.py), in
    numpy uint64: products of two words below t < 2^32 are exact."""
    psi_br, ipsi_br, ninv, _, _ = _host_tables(t, n)
    x = a.astype(np.uint64) % np.uint64(t)
    tt = np.uint64(t)
    if not inverse:
        m, step = 1, n
        while m < n:
            step //= 2
            xs = x.reshape(m, 2, step)
            s = psi_br[m:2 * m, None]
            u = xs[:, 0, :]
            v = xs[:, 1, :] * s % tt
            x = np.stack([(u + v) % tt, (u + tt - v) % tt], axis=1).reshape(n)
            m *= 2
        return x
    m, step = n // 2, 1
    while m >= 1:
        xs = x.reshape(m, 2, step)
        s = ipsi_br[m:2 * m, None]
        u, v = xs[:, 0, :], xs[:, 1, :]
        lo = (u + v) % tt
        hi = (u + tt - v) * s % tt
        x = np.stack([lo, hi], axis=1).reshape(n)
        m //= 2
        step *= 2
    return x * np.uint64(ninv) % tt


def encode_packed(values, t: int, n: int) -> np.ndarray:
    """Integer slot values -> coefficients in [0, t). Values fill row 0 then
    row 1 (vector length up to N)."""
    vals = np.asarray(values, np.int64).ravel()
    if len(vals) > n:
        raise ValueError("too many slots")
    spec = np.zeros(n, np.uint64)
    _, _, _, row0, row1 = _host_tables(t, n)
    v = np.mod(vals, t).astype(np.uint64)
    n_half = n // 2
    spec[row0[:min(len(v), n_half)]] = v[:n_half]
    if len(v) > n_half:
        spec[row1[:len(v) - n_half]] = v[n_half:]
    return _host_ntt(spec, t, n, inverse=True).astype(np.int64)


def decode_packed(coeffs, t: int, n: int, length: int | None = None
                  ) -> np.ndarray:
    """Coefficients mod t -> integer slot values (length defaults to N)."""
    spec = _host_ntt(np.mod(np.asarray(coeffs, np.int64), t), t, n,
                     inverse=False)
    _, _, _, row0, row1 = _host_tables(t, n)
    out = np.concatenate([spec[row0], spec[row1]]).astype(np.int64)
    return out[:length] if length else out


def coef_encode(values, t: int, n: int) -> np.ndarray:
    """CoefPacked encoding (reference: coefpackedencoding.h): values are the
    coefficients themselves."""
    vals = np.mod(np.asarray(values, np.int64).ravel(), t)
    out = np.zeros(n, np.int64)
    out[:len(vals)] = vals
    return out


def coef_decode(coeffs, t: int, n: int, length=None) -> np.ndarray:
    out = np.mod(np.asarray(coeffs, np.int64), t)
    return out[:length] if length else out


def string_encode(s: str, t: int, n: int) -> np.ndarray:
    """StringEncoding (reference: stringencoding.h): bytes as coefficients
    (requires t = 256 in the reference; we allow t >= 256)."""
    data = s.encode("utf-8")
    if len(data) > n:
        raise ValueError("string too long")
    out = np.zeros(n, np.int64)
    out[:len(data)] = np.frombuffer(data, np.uint8)
    return out


def string_decode(coeffs, t: int, n: int) -> str:
    vals = np.mod(np.asarray(coeffs, np.int64), t).astype(np.uint8)
    return bytes(vals).rstrip(b"\x00").decode("utf-8", errors="replace")
