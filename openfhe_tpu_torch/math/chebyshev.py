"""Chebyshev interpolation coefficients (host side).

A copy of `openfhe_tpu/math/chebyshev.py`: the port never imports the JAX
package, and its series evaluators branch on these coefficients, so the
lists must be bit-identical. Reference analog: OpenFHE's
src/core/lib/math/chebyshev.cpp (EvalChebyshevCoefficients) and
ckksrns-utils.cpp (LongDivisionChebyshev, the Paterson-Stockmeyer degree
table).
"""

from __future__ import annotations

import math

import numpy as np


def eval_chebyshev_coefficients(func, a: float, b: float, degree: int):
    """Chebyshev interpolation of `func` on [a, b], degree+1 coefficients.

    Uses the Chebyshev-Gauss nodes; returns c such that
    f(x) ~ c0/2 + sum_{k>=1} c_k T_k(2(x-a)/(b-a) - 1)
    (same convention as the reference: the c0 halving happens at eval time).
    """
    m = degree + 1
    nodes = np.cos(np.pi * (np.arange(m) + 0.5) / m)
    x = 0.5 * (b - a) * (nodes + 1.0) + a
    fx = np.array([func(v) for v in x], np.float64)
    k = np.arange(m)[:, None]
    tk = np.cos(k * np.pi * (np.arange(m)[None, :] + 0.5) / m)
    return (2.0 / m) * (tk @ fx)


def long_division_chebyshev(f, g):
    """Divide Chebyshev series f by g: returns (quotient, remainder) in the
    Chebyshev basis (reference: ckksrns-utils.cpp LongDivisionChebyshev).

    Uses the product rule T_i*T_j = (T_{i+j} + T_{|i-j|})/2.
    """
    f = [complex(v) for v in f]   # complex series supported
    g = [complex(v) for v in g]
    while len(g) > 1 and abs(g[-1]) < 1e-30:
        g.pop()
    n, m = len(f) - 1, len(g) - 1
    if n < m:
        return [0.0], f
    r = list(f)
    q = [0.0] * (n - m + 1)
    for k in range(n, m - 1, -1):
        if abs(r[k]) < 1e-300:
            continue
        d = k - m
        # leading coefficient of g*T_d at T_k: g[m] if d == 0 else g[m]/2
        c = r[k] / (g[m] if d == 0 else 0.5 * g[m])
        q[d] += c
        # r -= c * (g * T_d), using T_i*T_d = (T_{i+d} + T_{|i-d|})/2
        if d == 0:
            for i in range(m + 1):
                r[i] -= c * g[i]
        else:
            for i in range(m + 1):
                r[i + d] -= 0.5 * c * g[i]
                r[abs(i - d)] -= 0.5 * c * g[i]
    while len(r) > max(1, m) and abs(r[-1]) < 1e-9:
        r.pop()
    return q, r[:m] if len(r) > m else r


# Paterson-Stockmeyer optimal inner degree table
# (reference: ckksrns-utils.cpp:82-90 depth table)
def ps_split_degree(degree: int) -> int:
    """Inner polynomial degree k for PS evaluation of a degree-n series."""
    return max(1, 1 << int(round(math.log2(max(2.0, math.sqrt(degree / 2))))))
