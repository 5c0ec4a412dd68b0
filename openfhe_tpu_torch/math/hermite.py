"""Hermite trigonometric interpolation coefficients.

Counterpart of `openfhe_tpu/math/hermite.py` (numpy on the host, the same
code). Reference analog: src/core/lib/math/hermite.cpp
(GetHermiteTrigCoefficients): coefficients for approximating an integer
function f on Z_p by a trigonometric polynomial in exp(2*pi*i*x/p),
evaluated homomorphically with EvalPoly; the real part of the series value
is the interpolation result.  Orders 1-3 trade degree for smoothness.

The reference's O(p^2) nested exponential sums are all DFTs
of the sample vector y[j] = f(j); we compute one np.fft.fft and index it
(exp(-2*pi*i*(p+k)*j/p) == exp(-2*pi*i*k*j/p), so delta/omega reuse the same
spectrum).
"""

from __future__ import annotations

import numpy as np

_DELTA = 2.0 ** -32


def _trim(coeffs: np.ndarray) -> list:
    keep = 0
    for i, c in enumerate(coeffs):
        if abs(c.real) >= _DELTA or abs(c.imag) >= _DELTA:
            keep = i
    return list(coeffs[:keep + 1])


def get_hermite_trig_coefficients(func, p: int, order: int = 1,
                                  scale: float = 1.0) -> list:
    """(reference GetHermiteTrigCoefficients, hermite.cpp:51)"""
    if p == 0:
        raise ValueError("the degree of approximation cannot be zero")
    y = np.array([float(func(j)) for j in range(p)], np.float64)
    spec = np.fft.fft(y)                  # spec[i] = sum_j y_j e^{-2pi i ij/p}
    i_idx = np.arange(p, dtype=np.float64)

    if order == 1:
        coeffs = spec * (p - i_idx) / (p * p) / scale
        coeffs[0] /= 2.0
        return _trim(coeffs)

    if order == 2:
        if p % 2:
            # the JAX package indexes omega past its end at odd p (an
            # IndexError): refused here (ROADMAP queue 3)
            raise ValueError("order 2 needs an even p")
        pby2 = p >> 1
        total = p + pby2 + 1
        alpha = spec * 2.0 * (p - i_idx) / (p * p) / 2.0 / scale
        alpha[0] /= 2.0
        gamma = np.zeros(pby2)
        if p % 2 == 0 and pby2 > 0:
            gamma[-1] = 1.0
        i1 = np.arange(1, pby2 + 1, dtype=np.float64)
        factor = (2.0 - gamma) * i1 * (p - i1) / (p * p) / p / 2.0 / scale
        beta = spec[np.arange(1, pby2 + 1) % p] * factor
        delta = spec[np.arange(1, pby2 + 1) % p] * factor / 2.0
        omega = spec[(p - np.arange(1, pby2 + 1)) % p] * factor / 2.0
        coeffs = np.zeros(total, np.complex128)
        coeffs[0] = alpha[0]
        for i in range(1, total):
            if i < p:
                coeffs[i] = alpha[i]
            if i <= pby2:
                coeffs[i] += beta[i - 1]
            if pby2 <= i < p:
                coeffs[i] -= omega[p - i - 1]
            if i > p:
                coeffs[i] -= delta[i - p - 1]
        return _trim(coeffs)

    if order == 3:
        total = 2 * p
        alpha = spec * 2.0 * (p - i_idx) / (p * p) / 2.0 / scale
        alpha[0] /= 2.0
        i1 = np.arange(1, p, dtype=np.float64)
        factor = 2.0 * i1 * (p - i1) * (2.0 * p - i1) / 3.0 / (p * p) \
            / (p * p) / 2.0 / scale
        beta = spec[np.arange(1, p) % p] * factor
        delta = spec[np.arange(1, p) % p] * factor / 2.0
        omega = spec[(p - np.arange(1, p)) % p] * factor / 2.0
        coeffs = np.zeros(total, np.complex128)
        coeffs[0] = alpha[0]
        for i in range(1, total):
            if i < p:
                coeffs[i] = alpha[i]
            if i <= p - 1:
                coeffs[i] += beta[i - 1]
            if 1 <= i < p:
                coeffs[i] -= omega[p - i - 1]
            if i > p:
                coeffs[i] -= delta[i - p - 1]
        return _trim(coeffs)

    raise ValueError("order must be 1, 2, or 3")
