"""Lattice Gaussian sampling utilities (GPV / G-lattice / perturbation).

Counterpart of `openfhe_tpu/lattice/dgsampling.py` (reference analog:
dgsampling{,-impl}.h, LatticeGaussSampUtility: GaussSampGq /
GaussSampGqArbBase, Perturb / PerturbFloat, SampleC, ZSampleSigma2x2,
SampleMat, ZSampleF; https://eprint.iacr.org/2017/844 and 2018/946).

As in the JAX package, every per-coefficient loop of the reference is
vectorised across the n coefficients (`math/dgg.sample_integers` on a
tensor of centers, on their device), so the k-digit recurrences are the
only sequential dimension; the perturbation recursion (`zsample_f`,
`zsample_sigma_2x2`) runs on Field2n tensors. Every variate comes from a
draw source (`math/draws.py`) in the JAX package's order, so on the same
variates the integers are the JAX package's. The moduli here are below
2^31 (`lattice/ringq.py`), so int64 holds every digit computation that
the JAX package does in Python integers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from openfhe_tpu_torch.lattice.field2n import (COEFFICIENT, EVALUATION,
                                               Field2n, interleave)
from openfhe_tpu_torch.math.dgg import sample_integers
from openfhe_tpu_torch.math.matrix import Matrix

DG_ERROR = 8.27181e-25                       # 2^-80 (dgsampling.h:52)
N_MAX = 16384
SIGMA = math.sqrt(math.log(2 * N_MAX / DG_ERROR) / math.pi)
SPECTRAL_CONSTANT = 1.8


def spectral_bound(n: int, k: int, base: int) -> float:
    """(reference SPECTRAL_BOUND, dgsampling.h:63)"""
    return SPECTRAL_CONSTANT * (base + 1) * SIGMA * SIGMA * (
        math.sqrt(n * k) + math.sqrt(2 * n) + 4.7)


def spectral_bound_d(n: int, k: int, base: int, d: int) -> float:
    return SPECTRAL_CONSTANT * (base + 1) * SIGMA * SIGMA * (
        math.sqrt(d * n * k) + math.sqrt(2 * n) + 4.7)


def get_digits(v, base: int, k: int) -> torch.Tensor:
    """Base-`base` digits (LSD first) of each nonnegative entry of an
    int64 tensor -> [k, ...] int64 on its device."""
    v = torch.as_tensor(v, dtype=torch.int64)
    out = torch.empty((k,) + tuple(v.shape), dtype=torch.int64,
                      device=v.device)
    for i in range(k):
        out[i] = torch.remainder(v, base)
        v = torch.div(v, base, rounding_mode="floor")
    return out


# ---------------------------------------------------------------------------
# G-lattice sampling (digit decomposition of the syndrome)
# ---------------------------------------------------------------------------

def _gq_scaffold(modulus: int, base: int, k: int):
    """The modulus' digits (Python ints) and the floats l, h, c of the
    gadget lattice's basis, as the JAX package computes them."""
    m_digits = []
    m = modulus
    for _ in range(k):
        m_digits.append(m % base)
        m //= base
    l = np.zeros(k)
    h = np.zeros(k)
    l[0] = math.sqrt(base * (1 + 1 / k) + 1)
    for i in range(1, k):
        l[i] = math.sqrt(base * (1 + 1 / (k - i)))
    for i in range(1, k):
        h[i] = math.sqrt(base * (1 - 1 / (k - (i - 1))))
    c = np.zeros(k)
    c[0] = m_digits[0] / base
    for i in range(1, k):
        c[i] = (c[i - 1] + m_digits[i]) / base
    return m_digits, l, h, c


def _gq_combine(zc, m_digits, v_digits, base, k):
    z = torch.empty_like(zc)
    z[0] = base * zc[0] + m_digits[0] * zc[k - 1] + v_digits[0]
    for t in range(1, k - 1):
        z[t] = base * zc[t] - zc[t - 1] + m_digits[t] * zc[k - 1] \
            + v_digits[t]
    z[k - 1] = m_digits[k - 1] * zc[k - 1] - zc[k - 2] + v_digits[k - 1]
    return z


def _sample_c(c: np.ndarray, sigma: float, a: torch.Tensor, draws):
    """(reference SampleC) vectorised over coefficients; a is [k, n]
    float64 and updated in place, as the reference does."""
    k = len(c)
    zc = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    zc[k - 1] = sample_integers(-a[k - 1] / c[k - 1], sigma / c[k - 1],
                                draws)
    c_t = torch.as_tensor(c, dtype=torch.float64, device=a.device)
    a += zc[k - 1][None, :] * c_t[:, None]
    zc[:k - 1] = sample_integers(-a[:k - 1], sigma, draws)
    return zc


def _syndrome(base: int, v_digits: torch.Tensor, p: torch.Tensor,
              k: int) -> torch.Tensor:
    """a_t = (a_{t-1} + v_t - p_t) / base, float64 as the JAX package
    computes it."""
    a = torch.empty(p.shape, dtype=torch.float64, device=p.device)
    a[0] = (v_digits[0] - p[0]).double() / base
    for t in range(1, k):
        a[t] = (a[t - 1] + v_digits[t] - p[t]) / base
    return a


def gauss_samp_gq(u_coeffs: torch.Tensor, stddev: float, k: int,
                  modulus: int, base: int, draws) -> torch.Tensor:
    """(reference GaussSampGq) Sample z with G z = u mod q, G = I x g^T.

    u_coeffs: [n] int64 syndrome coefficients in [0, q). Returns [k, n]
    int64. Uses the integer Perturb path (exact nearest-plane on the
    gadget lattice)."""
    sigma = stddev / (base + 1)
    m_digits, l, h, c = _gq_scaffold(modulus, base, k)
    n = u_coeffs.shape[0]
    dev = u_coeffs.device
    v_digits = get_digits(u_coeffs, base, k)              # [k, n]

    # Perturb (vectorised over the n coefficients; sequential in digits)
    zp = torch.empty((k, n), dtype=torch.int64, device=dev)
    d = torch.zeros(n, dtype=torch.float64, device=dev)
    for i in range(k):
        zp[i] = sample_integers(d / l[i], sigma / l[i], draws)
        d = -zp[i].double() * h[i]
    p = torch.empty((k, n), dtype=torch.int64, device=dev)
    p[0] = (2 * base + 1) * zp[0] + base * zp[1]
    for i in range(1, k - 1):
        p[i] = base * (zp[i - 1] + 2 * zp[i] + zp[i + 1])
    p[k - 1] = base * (zp[k - 2] + 2 * zp[k - 1])

    a = _syndrome(base, v_digits, p, k)
    zc = _sample_c(c, sigma, a, draws)
    return _gq_combine(zc, m_digits, v_digits, base, k)


def gauss_samp_gq_arb_base(u_coeffs: torch.Tensor, stddev: float, k: int,
                           modulus: int, base: int, draws) -> torch.Tensor:
    """(reference GaussSampGqArbBase) float-perturbation variant used by
    GaussSamp for arbitrary bases."""
    sigma = stddev / (base + 1)
    m_digits, l, h, c = _gq_scaffold(modulus, base, k)
    n = u_coeffs.shape[0]
    v_digits = get_digits(u_coeffs, base, k)

    z = 0.0 + sigma * draws.normal((k, n))
    p = torch.empty((k, n), dtype=torch.float64, device=u_coeffs.device)
    for i in range(k - 1):
        p[i] = l[i] * z[i] + h[i + 1] * z[i + 1]
    p[k - 1] = h[k - 1] * z[k - 1]

    a = _syndrome(base, v_digits, p, k)
    zc = _sample_c(c, sigma, a, draws)
    return _gq_combine(zc, m_digits, v_digits, base, k)


# ---------------------------------------------------------------------------
# perturbation sampling in the cyclotomic field (Field2n recursion)
# ---------------------------------------------------------------------------

def zsample_f(f: Field2n, c: Field2n, draws) -> torch.Tensor:
    """(reference ZSampleF) Sample an integer vector with covariance f,
    center c (both COEFFICIENT). Returns [size] int64."""
    if f.size() == 1:
        sigma = math.sqrt(max(float(f.data[0].real), 0.0))
        return sample_integers(c.data[:1].real, sigma, draws)
    f0 = f.ExtractEven().SetFormat(EVALUATION)
    f1 = f.ExtractOdd().SetFormat(EVALUATION)
    c_perm = (c.ExtractEven(), c.ExtractOdd())
    q_z = zsample_sigma_2x2(f0, f1, f0, c_perm, draws)
    return interleave(q_z)      # [evens | odds] -> interleaved


def zsample_sigma_2x2(a: Field2n, b: Field2n, d: Field2n, c,
                      draws) -> torch.Tensor:
    """(reference ZSampleSigma2x2) 2x2 block Schur-complement sampling.
    a, b, d in EVALUATION; c = (c0, c1) Field2n in COEFFICIENT.
    Returns [2n] int64."""
    c0, c1 = c
    d_coeff = d.SetFormat(COEFFICIENT)
    q2 = zsample_f(d_coeff, c1, draws)
    q2_f = Field2n.from_int_vector(q2)

    q2_minus_c2 = (q2_f - c1).SwitchFormat()           # -> EVALUATION
    product = (b * d.Inverse() * q2_minus_c2).SetFormat(COEFFICIENT)
    c1_new = c0 + product

    f = (a - b * d.Inverse() * b.Transpose()).SetFormat(COEFFICIENT)
    q1 = zsample_f(f, c1_new, draws)
    return torch.cat([q1, q2])


def sample_mat(A: Matrix, B: Matrix, D: Matrix, C: Matrix,
               draws) -> torch.Tensor:
    """(reference SampleMat) recursive block sampling for matrices of
    Field2n; C is a column of COEFFICIENT-format centers. Returns the
    stacked integer vector."""
    d_tot = C.GetRows()
    if d_tot == 2:
        return zsample_sigma_2x2(A(0, 0), B(0, 0), D(0, 0),
                                 (C(0, 0), C(1, 0)), draws)
    n = D(0, 0).size()
    dev = D(0, 0).device
    dim_a = A.GetRows()
    dim_d = D.GetRows()
    alloc = lambda: Field2n.zeros(n, EVALUATION, device=dev)

    c1 = C.ExtractRows(dim_a, d_tot - 1)
    c0 = C.ExtractRows(0, dim_a - 1)

    if dim_d == 1:
        d_eval = D(0, 0)
        q1 = zsample_f(d_eval.SetFormat(COEFFICIENT), c1(0, 0), draws)
        d_inverse = Matrix(alloc, 1, 1).set(0, 0, D(0, 0).Inverse())
        q_f1 = Matrix(alloc, 1, 1).set(
            0, 0, Field2n.from_int_vector(q1))
    elif dim_d == 2:
        q1 = zsample_sigma_2x2(D(0, 0), D(0, 1), D(1, 1),
                               (c1(0, 0), c1(1, 0)), draws)
        q_f1 = Matrix(alloc, 2, 1)
        for i in range(2):
            q_f1.set(i, 0, Field2n.from_int_vector(q1[i * n:(i + 1) * n]))
        det = D(0, 0) * D(1, 1) - D(0, 1) * D(1, 0)
        det_inv = det.Inverse()
        d_inverse = Matrix(alloc, 2, 2)
        d_inverse.set(0, 0, D(1, 1) * det_inv)
        d_inverse.set(0, 1, -D(0, 1) * det_inv)
        d_inverse.set(1, 0, -D(1, 0) * det_inv)
        d_inverse.set(1, 1, D(0, 0) * det_inv)
    else:
        na = (dim_d + 1) // 2
        nd = dim_d // 2
        new_a = Matrix(alloc, na, na)
        new_b = Matrix(alloc, na, nd)
        new_d = Matrix(alloc, nd, nd)
        for i in range(na):
            for j in range(na):
                new_a.set(i, j, D(i, j))
            for j in range(nd):
                new_b.set(i, j, D(i, j + na))
        for i in range(nd):
            for j in range(nd):
                new_d.set(i, j, D(i + na, j + na))
        q1 = sample_mat(new_a, new_b, new_d, c1, draws)
        q_f1 = Matrix(alloc, dim_d, 1)
        for i in range(dim_d):
            q_f1.set(i, 0, Field2n.from_int_vector(q1[i * n:(i + 1) * n]))
        det = D.Determinant()
        d_inverse = D.CofactorMatrix().Transpose().ScalarMult(det.Inverse())

    sigma_new = A - B * d_inverse * B.Transpose()
    diff = (q_f1 - c1).SetFormat(EVALUATION)
    c_new = (c0.SetFormat(EVALUATION)
             + B * d_inverse * diff).SetFormat(COEFFICIENT)

    na = (dim_a + 1) // 2
    nd = dim_a // 2
    new_a = Matrix(alloc, na, na)
    new_b = Matrix(alloc, na, nd)
    new_d = Matrix(alloc, nd, nd)
    for i in range(na):
        for j in range(na):
            new_a.set(i, j, sigma_new(i, j))
        for j in range(nd):
            new_b.set(i, j, sigma_new(i, j + na))
    for i in range(nd):
        for j in range(nd):
            new_d.set(i, j, sigma_new(i + na, j + na))
    q0 = sample_mat(new_a, new_b, new_d, c_new, draws)
    return torch.cat([q0, q1])
