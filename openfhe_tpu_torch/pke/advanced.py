"""AdvancedSHE: many-operand trees, rotation ladders, polynomial and
Chebyshev series.

Counterpart of `openfhe_tpu/pke/advanced.py` (reference analog:
base-advancedshe.cpp EvalAddMany / EvalMultMany, EvalLinearWSum, EvalSum
via rotation ladders, EvalInnerProduct, EvalMerge; ckksrns-advancedshe.cpp
EvalPolyLinear, EvalChebyshevSeries{Linear,PS}, EvalChebyshevFunction,
EvalSin / Cos / Logistic / Divide). Each function takes the context `cc`
and calls its public ops, so on a CUDA context every ciphertext product
is one fused EvalMult chain and every rotation one fused key switch; the
plaintext and scalar products and the adds are plain torch.

The Paterson-Stockmeyer series uses the identity f = q T_g + r of
Chebyshev long division: eval(q) * T_g + eval(r), recursively. Its
branches test float coefficients (`abs(f[deg]) < 1e-300`, `f[j] == 0`),
so `math/chebyshev.py` is a bit-identical copy of the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np

from openfhe_tpu_torch.math.chebyshev import (eval_chebyshev_coefficients,
                                              long_division_chebyshev)
from openfhe_tpu_torch.pke.ciphertext import Ciphertext


def _tree(op, cts) -> Ciphertext:
    """Pairwise binary tree of `op` over cts (odd ones carried up)."""
    cts = list(cts)
    while len(cts) > 1:
        nxt = [op(cts[i], cts[i + 1]) for i in range(0, len(cts) - 1, 2)]
        if len(cts) % 2:
            nxt.append(cts[-1])
        cts = nxt
    return cts[0]


def eval_add_many(cc, cts) -> Ciphertext:
    return _tree(cc.EvalAdd, cts)


def eval_mult_many(cc, cts) -> Ciphertext:
    return _tree(cc.EvalMult, cts)


def eval_linear_wsum(cc, cts, weights) -> Ciphertext:
    """sum_i w_i * ct_i for scalar weights."""
    acc = cc.EvalMult(cts[0], weights[0])
    for ct, w in zip(cts[1:], weights[1:]):
        acc = cc.EvalAdd(acc, cc.EvalMult(ct, w))
    return acc


def _ladder(cc, ct: Ciphertext, start: int, stop: int) -> Ciphertext:
    """out += rot(out, j) for j = start, 2*start, ... < stop."""
    out = ct
    j = start
    while j < stop:
        out = cc.EvalAdd(out, cc.EvalRotate(out, j))
        j <<= 1
    return out


def eval_sum_keygen(cc, sk, batch_size: int | None = None) -> None:
    batch = batch_size or cc.slots
    cc.EvalRotateKeyGen(sk, [1 << j for j in range(int(math.log2(batch)))])


def eval_sum(cc, ct: Ciphertext, batch_size: int | None = None) -> Ciphertext:
    """Sum over `batch_size` slots into every slot (log2 rotations)."""
    return _ladder(cc, ct, 1, batch_size or ct.slots)


def eval_sum_rows_keygen(cc, sk, row_size: int, batch: int) -> None:
    rots = []
    j = row_size
    while j < batch:
        rots.append(j)
        j <<= 1
    cc.EvalRotateKeyGen(sk, rots)


def eval_sum_rows(cc, ct: Ciphertext, row_size: int,
                  batch: int | None = None) -> Ciphertext:
    """Sum matrix rows (slots viewed as [batch/row_size, row_size])."""
    return _ladder(cc, ct, row_size, batch or ct.slots)


def eval_sum_cols_keygen(cc, sk, row_size: int) -> None:
    cc.EvalRotateKeyGen(sk, [1 << j for j in range(int(math.log2(row_size)))])


def eval_sum_cols(cc, ct: Ciphertext, row_size: int) -> Ciphertext:
    return _ladder(cc, ct, 1, row_size)


def eval_inner_product(cc, ct1: Ciphertext, ct2: Ciphertext,
                       batch_size: int | None = None) -> Ciphertext:
    return eval_sum(cc, cc.EvalMult(ct1, ct2), batch_size)


def eval_merge(cc, cts) -> Ciphertext:
    """Slot 0 of each ct_i into slot i of one ciphertext (reference
    EvalMerge, base-advancedshe.cpp): each ct_i times the plaintext mask
    (1, 0, ..., 0), rotated by -i, summed. The JAX package passes the mask
    to EvalMult as a bare numpy array, which EvalMult does not take; here
    it is encoded at the ciphertext's level first (`_encode_like_mult`)."""
    mask0 = np.zeros(cts[0].slots)
    mask0[0] = 1.0
    acc = None
    for i, ct in enumerate(cts):
        masked = cc.EvalMult(ct, cc._encode_like_mult(ct, mask0))
        if i:
            masked = cc.EvalRotate(masked, -i)
        acc = masked if acc is None else cc.EvalAdd(acc, masked)
    return acc


# ---------------------------------------------------------------------------
# polynomials in the power basis
# ---------------------------------------------------------------------------

def _powers(cc, ct: Ciphertext, n: int) -> dict:
    """ct^1..ct^n, each by a log-depth binary split."""
    pows = {1: ct}
    for j in range(2, n + 1):
        half = j // 2
        if j % 2 == 0:
            pows[j] = cc.EvalSquare(pows[half])
        else:
            pows[j] = cc.EvalMult(pows[half + 1], pows[half])
    return pows


def _as_scalars(coeffs) -> list:
    out = []
    for c in coeffs:
        c = complex(c)
        out.append(c.real if c.imag == 0.0 else c)
    return out


def eval_powers(cc, ct: Ciphertext, coefficients) -> dict:
    """The power basis ct^1..ct^deg for a coefficient vector (reference
    EvalPowers), for several EvalPolyWithPrecomp calls."""
    return _powers(cc, ct, max(1, len(coefficients) - 1))


def eval_poly_with_precomp(cc, pows: dict, coeffs) -> Ciphertext:
    """sum_j coeffs[j] ct^j on a precomputed power basis (reference
    EvalPolyWithPrecomp)."""
    coeffs = _as_scalars(coeffs)
    acc = None
    for j in range(1, len(coeffs)):
        if coeffs[j] == 0.0:
            continue
        term = cc.EvalMult(pows[j], coeffs[j])
        acc = term if acc is None else cc.EvalAdd(acc, term)
    if acc is None:
        acc = cc.EvalMult(pows[1], 0.0)
    if coeffs[0] != 0.0:
        acc = cc.EvalAdd(acc, coeffs[0])
    return acc


def eval_poly_linear(cc, ct: Ciphertext, coeffs) -> Ciphertext:
    """f(ct) = sum_j coeffs[j] ct^j, real or complex coefficients
    (reference EvalPolyLinear)."""
    coeffs = _as_scalars(coeffs)
    return eval_poly_with_precomp(cc, _powers(cc, ct, len(coeffs) - 1),
                                  coeffs)


def eval_poly(cc, ct: Ciphertext, coeffs) -> Ciphertext:
    """EvalPoly: the power basis by binary splits at every degree (already
    log depth), as the JAX package does."""
    return eval_poly_linear(cc, ct, coeffs)


# ---------------------------------------------------------------------------
# Chebyshev series
# ---------------------------------------------------------------------------

def _to_unit_interval(cc, ct: Ciphertext, a: float, b: float) -> Ciphertext:
    """y = 2 (x - a) / (b - a) - 1, rescaled under the AUTO modes."""
    if (a, b) == (-1.0, 1.0):
        return ct
    scale = 2.0 / (b - a)
    shift = -(2.0 * a / (b - a) + 1.0)
    y = cc.EvalAdd(cc.EvalMult(ct, scale), shift)
    if cc._auto() and y.noise_deg == 2:
        y = cc.ModReduce(y)
    return y


def _cheb_basis(cc, y: Ciphertext, upto: int) -> dict:
    """T_1..T_upto of y in log depth: T_{a+b} = 2 T_a T_b - T_{|a-b|}."""
    t = {1: y}
    for j in range(2, upto + 1):
        a = j // 2
        b = j - a
        prod = cc.EvalMult(t[a], t[b])
        two = cc.EvalAdd(prod, prod)
        d = abs(a - b)
        t[j] = cc.EvalSub(two, 1.0 if d == 0 else t[d])
    return t


def eval_cheby_polys(cc, ct: Ciphertext, coefficients, a: float,
                     b: float) -> dict:
    """T_1..T_deg of the input mapped to [-1, 1] (reference
    EvalChebyPolys), for several EvalChebyshevSeriesWithPrecomp calls."""
    return _cheb_basis(cc, _to_unit_interval(cc, ct, a, b),
                       max(1, len(coefficients) - 1))


def _series_sum(cc, t: dict, coeffs) -> Ciphertext:
    """c_1 T_1 + ... + c_n T_n + c_0 / 2 (the reference's c_0 halving)."""
    n = len(coeffs) - 1
    acc = cc.EvalMult(t[1], coeffs[1] if n >= 1 else 0.0)
    for j in range(2, n + 1):
        if coeffs[j] == 0:
            continue
        acc = cc.EvalAdd(acc, cc.EvalMult(t[j], coeffs[j]))
    return cc.EvalAdd(acc, coeffs[0] / 2.0)


def eval_chebyshev_series_with_precomp(cc, basis: dict,
                                       coefficients) -> Ciphertext:
    """sum c_k T_k on a precomputed basis (reference
    EvalChebyshevSeriesWithPrecomp)."""
    return _series_sum(cc, basis, [complex(c) for c in coefficients])


def eval_chebyshev_series_linear(cc, ct: Ciphertext, coefficients,
                                 a: float, b: float) -> Ciphertext:
    """sum c_k T_k(y), y = 2 (x - a) / (b - a) - 1, c_0 halved (reference
    EvalChebyshevSeriesLinear); complex coefficients ride the encoding."""
    coeffs = [complex(c) for c in coefficients]
    t = _cheb_basis(cc, _to_unit_interval(cc, ct, a, b),
                    max(1, len(coeffs) - 1))
    return _series_sum(cc, t, coeffs)


def eval_chebyshev_series_ps(cc, ct: Ciphertext, coefficients,
                             a: float, b: float) -> Ciphertext:
    """Paterson-Stockmeyer evaluation by Chebyshev long division
    (reference EvalChebyshevSeriesPS): baby steps T_1..T_k, giant steps
    T_k, T_2k, T_4k, ..."""
    coeffs = [complex(c) for c in coefficients]
    coeffs[0] /= 2.0           # the reference's c_0 halving, folded in
    n = len(coeffs) - 1
    if n <= 4:
        return eval_chebyshev_series_linear(cc, ct, list(coefficients), a, b)
    y = _to_unit_interval(cc, ct, a, b)
    k = max(2, 1 << int(math.ceil(math.log2(math.sqrt(n + 1)))))
    babies = _cheb_basis(cc, y, k)
    giants = {k: babies[k]}
    g = 2 * k
    while g <= n:
        prod = cc.EvalSquare(giants[g // 2])
        giants[g] = cc.EvalSub(cc.EvalAdd(prod, prod), 1.0)
        g <<= 1

    def eval_series(f):
        """sum f_j T_j with T_0 = 1, recursively."""
        deg = len(f) - 1
        while deg > 0 and abs(f[deg]) < 1e-300:
            deg -= 1
        f = f[:deg + 1]
        if deg <= k:
            acc = None
            for j in range(1, deg + 1):
                if f[j] == 0:
                    continue
                term = cc.EvalMult(babies[j], f[j])
                acc = term if acc is None else cc.EvalAdd(acc, term)
            if acc is None:
                zero = cc.EvalMult(babies[1], 0.0)
                return zero if f[0] == 0 else cc.EvalAdd(zero, f[0])
            return cc.EvalAdd(acc, f[0]) if f[0] != 0 else acc
        g = max(d for d in giants if d <= deg)
        tg = [0.0] * (g + 1)
        tg[g] = 1.0
        q, r = long_division_chebyshev(f, tg)
        q_ct = eval_series(q)
        r_ct = eval_series(r)
        return cc.EvalAdd(cc.EvalMult(q_ct, giants[g]), r_ct)

    return eval_series(coeffs)


def eval_chebyshev_series(cc, ct, coefficients, a, b) -> Ciphertext:
    """Paterson-Stockmeyer above degree 8, else the linear series."""
    if len(coefficients) - 1 > 8:
        return eval_chebyshev_series_ps(cc, ct, coefficients, a, b)
    return eval_chebyshev_series_linear(cc, ct, coefficients, a, b)


def eval_chebyshev_function(cc, func, ct, a, b, degree) -> Ciphertext:
    """Interpolate `func` on [a, b] at `degree`, then evaluate (reference
    EvalChebyshevFunction)."""
    coeffs = eval_chebyshev_coefficients(func, a, b, degree)
    return eval_chebyshev_series(cc, ct, coeffs, a, b)


def eval_sin(cc, ct, a, b, degree):
    return eval_chebyshev_function(cc, math.sin, ct, a, b, degree)


def eval_cos(cc, ct, a, b, degree):
    return eval_chebyshev_function(cc, math.cos, ct, a, b, degree)


def logistic(x: float) -> float:
    return 1.0 / (1.0 + math.exp(-x))


def eval_logistic(cc, ct, a, b, degree):
    return eval_chebyshev_function(cc, logistic, ct, a, b, degree)


def eval_divide(cc, ct, a, b, degree):
    return eval_chebyshev_function(cc, lambda x: 1.0 / x, ct, a, b, degree)
