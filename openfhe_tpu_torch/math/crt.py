"""Host-side exact CRT interpolation and residue generation.

Counterpart of `openfhe_tpu/math/crt.py` (numpy and Python ints on the
host). Reference analog: DCRTPolyInterface::CRTInterpolate. It sits at the
data boundary (encode, decode), never on the device path. Python ints give
exact arbitrary precision in place of the reference's BigInteger backends.
"""

from __future__ import annotations

import numpy as np


def crt_precompute(moduli):
    big = 1
    for m in moduli:
        big *= m
    coeffs = []
    for m in moduli:
        h = big // m
        coeffs.append(h * pow(h % m, -1, m))
    return big, coeffs


def interpolate(residues: np.ndarray, moduli) -> tuple:
    """Exact CRT lift of [k, N] residues -> (object array of Python ints
    in [0, Q), Q)."""
    big, coeffs = crt_precompute(moduli)
    acc = np.zeros(residues.shape[-1], dtype=object)
    for i, c in enumerate(coeffs):
        acc = acc + residues[i].astype(np.int64).astype(object) * c
    return acc % big, big


def interpolate_centered(residues: np.ndarray, moduli) -> np.ndarray:
    """Exact CRT lift of [k, N] residues centered to (-Q/2, Q/2], as an
    object (Python int) array."""
    acc, big = interpolate(residues, moduli)
    return np.where(acc > big >> 1, acc - big, acc)


def interpolate_centered_float(residues: np.ndarray, moduli) -> np.ndarray:
    """Centered CRT value as float64 (the CKKS decode), exact up to the
    final float64 rounding."""
    centered = interpolate_centered(np.asarray(residues), moduli)
    return np.array([float(v) for v in centered], np.float64)


def to_residues_host(values, moduli) -> np.ndarray:
    """Host lift of (possibly big) signed ints -> [k, N] uint32 residues."""
    vals = np.asarray(values)
    mods = [int(m) for m in moduli]
    if vals.dtype != object:
        q = np.array(mods, np.int64)[:, None]
        return np.mod(vals.astype(np.int64)[None, :], q).astype(np.uint32)
    out = np.zeros((len(mods), len(vals)), np.uint32)
    for i, m in enumerate(mods):
        out[i] = (vals % m).astype(np.uint64).astype(np.uint32)
    return out
