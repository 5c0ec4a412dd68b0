"""Host-side exact CRT interpolation and residue generation.

Counterpart of `openfhe_tpu/math/crt.py` (numpy and Python ints on the
host). Reference analog: DCRTPolyInterface::CRTInterpolate. It sits at the
data boundary (encode, decode), never on the device path. Python ints give
exact arbitrary precision in place of the reference's BigInteger backends.

As in the JAX package, the CKKS decode (`interpolate_centered_float`) and
the lift of int64 values (`to_residues_host`) take the native library
(`native.py`, Garner's CRT in C++); their Python paths stay beside them
as the plain twins. Two faults of the native decode are kept out: it
takes the sign from the top Garner digit alone, so a value within half a
top digit of +-Q/2 comes back with the wrong sign, and its weights are
doubles, NaN or inf once Q passes 2^1024. The values it may have got
wrong (magnitude at least (Q - Q/q_top)/2) are recomputed exactly, and
chains above NATIVE_DECODE_BITS bits take the Python path.
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


def to_float(centered_obj: np.ndarray) -> np.ndarray:
    """An object array of Python ints as float64."""
    return np.array([float(v) for v in centered_obj], np.float64)


def interpolate_centered(residues: np.ndarray, moduli) -> np.ndarray:
    """Exact CRT lift of [k, N] residues centered to (-Q/2, Q/2], as an
    object (Python int) array."""
    acc, big = interpolate(residues, moduli)
    return np.where(acc > big >> 1, acc - big, acc)


NATIVE_DECODE_BITS = 1000


def interpolate_centered_float(residues: np.ndarray, moduli) -> np.ndarray:
    """Centered CRT value as float64 (the CKKS decode), through the
    native Garner kernel (see the module docstring); within a few ulps
    of the exact value's rounding, which the plain twin
    `_interpolate_centered_float_py` gives."""
    res = np.ascontiguousarray(residues, np.uint32)
    mods = [int(m) for m in moduli]
    big = 1
    for m in mods:
        big *= m
    if big.bit_length() > NATIVE_DECODE_BITS:
        return _interpolate_centered_float_py(res, mods)
    from openfhe_tpu_torch import native
    out = native.crt_interpolate_centered_double(res, mods)
    edge = float((big - big // mods[-1]) // 2) * (1 - 2.0 ** -40)
    suspect = np.nonzero(~(np.abs(out) < edge))[0]
    if len(suspect):
        out[suspect] = _interpolate_centered_float_py(res[:, suspect], mods)
    return out


def _interpolate_centered_float_py(residues: np.ndarray,
                                   moduli) -> np.ndarray:
    """Plain twin of `interpolate_centered_float`: the exact centered
    value (Python ints), rounded to float64 once."""
    centered = interpolate_centered(np.asarray(residues), moduli)
    return np.array([float(v) for v in centered], np.float64)


def to_residues_host(values, moduli) -> np.ndarray:
    """Host lift of (possibly big) signed ints -> [k, N] uint32 residues:
    int64 values through the native library, Python ints in Python."""
    vals = np.asarray(values)
    mods = [int(m) for m in moduli]
    if vals.dtype != object:
        from openfhe_tpu_torch import native
        return native.to_residues_i64(vals.astype(np.int64), mods)
    return _to_residues_host_py(vals, mods)


def _to_residues_host_py(values, moduli) -> np.ndarray:
    """Plain twin of `to_residues_host`."""
    vals = np.asarray(values)
    mods = [int(m) for m in moduli]
    if vals.dtype != object:
        q = np.array(mods, np.int64)[:, None]
        return np.mod(vals.astype(np.int64)[None, :], q).astype(np.uint32)
    out = np.zeros((len(mods), len(vals)), np.uint32)
    for i, m in enumerate(mods):
        out[i] = (vals % m).astype(np.uint64).astype(np.uint32)
    return out
