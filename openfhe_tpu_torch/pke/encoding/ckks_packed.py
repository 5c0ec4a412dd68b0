"""CKKS packed encoding: complex slots <-> ring coefficients.

A copy of `openfhe_tpu/pke/encoding/ckks_packed.py`. Reference analog:
OpenFHE's src/pke/lib/encoding/ckkspackedencoding.cpp:132-493 (canonical
embedding via DiscreteFourierTransform::FFTSpecial).

Encode/decode are *host-side* O(N log N) numpy FFTs (they
sit at the data boundary, once per plaintext, exactly like the reference's
host FFTSpecial); the device only sees RNS residue tensors. The canonical
embedding at the odd powers of the 2N-th root is computed as a twisted
length-N FFT:  a(zeta^(2t+1)) = DFT_N(a_i * zeta^i)[t]  with zeta=e^(i*pi/N).
Slot j of a plaintext lives at exponent 5^j mod 2N; conjugate slots carry
the complex-conjugate values so encoded polynomials are real.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _slot_index_tables(n: int, slots: int):
    """(slot_pos, conj_pos): DFT-bin index of slot j and of its conjugate."""
    two_n = 2 * n
    e = 1
    pos = np.zeros(slots, np.int64)
    cpos = np.zeros(slots, np.int64)
    g = 5
    for j in range(slots):
        pos[j] = (e - 1) // 2
        cpos[j] = (two_n - e - 1) // 2
        e = (e * g) % two_n
    return pos, cpos


@functools.lru_cache(maxsize=None)
def _twist(n: int) -> np.ndarray:
    return np.exp(1j * np.pi * np.arange(n) / n)


def encode_to_coeffs(values, n: int, slots: int, scale: float) -> np.ndarray:
    """Complex slot values -> integer coefficient vector (object dtype ints).

    Supports sparse packing (slots < N/2, power of two): the inverse
    embedding is computed on the `slots`-slot subring and replicated, so the
    encoded polynomial lives in the subring (as the reference does for
    sparse bootstrapping, ckkspackedencoding.cpp).
    """
    if slots > n // 2:
        raise ValueError(f"slots={slots} exceeds N/2={n // 2}")
    z = np.zeros(slots, np.complex128)
    vals = np.asarray(values, np.complex128).ravel()[:slots]
    z[:len(vals)] = vals
    spec = np.zeros(n, np.complex128)
    pos, cpos = _slot_index_tables(n, slots)
    if slots == n // 2:
        spec[pos] = z
        spec[cpos] = np.conj(z)
    else:
        # replicate the sparse slots across the full slot set: values at
        # 5^j for j >= slots repeat with period `slots`
        full_pos, full_cpos = _slot_index_tables(n, n // 2)
        zfull = np.tile(z, (n // 2) // slots)
        spec[full_pos] = zfull
        spec[full_cpos] = np.conj(zfull)
    b = np.fft.fft(spec) / n
    a = b * np.conj(_twist(n))
    coeffs = np.real(a) * scale
    if np.abs(coeffs).max() < float(1 << 62):
        return np.round(coeffs).astype(np.int64)
    # composite degree-2 scales (~2^100) exceed int64: round through Python
    # ints (exact for the float64 value; relative error 2^-53 stays below
    # the composite noise floor)
    return np.array([int(round(v)) for v in coeffs], dtype=object)


def decode_from_coeffs(coeffs, n: int, slots: int, scale: float) -> np.ndarray:
    """Real coefficient vector (float or int) -> complex slot values."""
    a = np.asarray(coeffs, np.float64)
    spec = np.fft.ifft(a * _twist(n)) * n
    pos, _ = _slot_index_tables(n, slots)
    return spec[pos] / scale
