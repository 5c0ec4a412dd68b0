"""CKKS approximation error in bits of precision.

A copy of `openfhe_tpu/utils/precision.py`. Reference analog:
CalculateApproximationError in OpenFHE's
src/pke/extras/ckks-bootstrapping-precision.cpp:65-76: the precision is the
negative base-2 logarithm of the average L1 error between the homomorphic
result and the cleartext computation.
"""

from __future__ import annotations

import numpy as np


def calculate_approximation_error(result, expected) -> float:
    """Precision bits of `result` against `expected` (higher = better).

    Accepts real or complex arrays of equal length; returns
    |log2(mean |result - expected|)|, or 60.0 when the error is exactly
    zero (beyond double measurement range).
    """
    r = np.asarray(result).ravel()
    e = np.asarray(expected).ravel()
    if r.shape != e.shape:
        raise ValueError(
            f"cannot compare vectors of different lengths: {r.shape} vs "
            f"{e.shape}")
    err = float(np.mean(np.abs(r - e)))
    if err == 0.0:
        return 60.0
    return abs(float(np.log2(err)))
