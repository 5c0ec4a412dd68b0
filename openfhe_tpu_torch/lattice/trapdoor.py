"""RLWE lattice trapdoors and GPV Gaussian preimage sampling.

Counterpart of `openfhe_tpu/lattice/trapdoor.py` (reference analog:
trapdoor{,-impl}.h, RLWETrapdoorPair, TrapdoorGen, GaussSamp,
ZSampleSigmaP, and trapdoor-poly.cpp; https://eprint.iacr.org/2017/844).

The public key is A = [1, a, g_i - (a r_i + e_i)] with trapdoor (r, e);
GaussSamp produces x with A x = u mod q and ||x|| ~ spectral_bound, via a
perturbation vector (ZSampleSigmaP: Schur-complement Field2n sampling)
plus G-lattice sampling of the perturbed syndrome (`dgsampling.py`).
Polynomials are `RingPoly`s on their ring's device (their NTTs kernel m
or kernels a/b on the card), field elements Field2n tensors there, and
every variate comes from a draw source (`math/draws.py`) in the JAX
package's order: on the JAX package's variates these give its words.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from openfhe_tpu_torch.lattice import dgsampling as dgs
from openfhe_tpu_torch.lattice.field2n import COEFFICIENT, EVALUATION, Field2n
from openfhe_tpu_torch.lattice.ringq import RingParams, RingPoly
from openfhe_tpu_torch.math.dgg import sample_integers
from openfhe_tpu_torch.math.draws import torch_draws
from openfhe_tpu_torch.math.matrix import Matrix


@dataclass
class RLWETrapdoorPair:
    """(reference trapdoor.h:59)"""
    m_r: Matrix
    m_e: Matrix


def _zero_alloc(params):
    return lambda: RingPoly(params, None, EVALUATION)


def gadget_k(q: int, base: int, bal: bool = False) -> int:
    n_bits = math.floor(math.log2(q - 1) + 1.0)
    k = math.ceil(n_bits / math.log2(base))
    return k + 1 if bal else k


def trapdoor_gen(params: RingParams, stddev: float, base: int = 2,
                 bal: bool = False, draws=None):
    """(reference TrapdoorGen, trapdoor-poly.cpp) -> (A [1 x k+2] Matrix,
    RLWETrapdoorPair). `draws` defaults to a fresh `torch.Generator` on
    the ring's device."""
    draws = draws if draws is not None else torch_draws(params.device)
    k = gadget_k(params.q, base, bal)
    n = params.n
    alloc = _zero_alloc(params)
    zeros = torch.zeros(n, dtype=torch.float64, device=params.device)

    def gauss_poly():
        coeffs = sample_integers(zeros, stddev, draws)
        return RingPoly.from_coeffs(params, coeffs).SetFormat(EVALUATION)

    a = RingPoly.uniform(params, draws)
    r = Matrix(alloc, 1, k, gauss_poly)
    e = Matrix(alloc, 1, k, gauss_poly)
    g = Matrix(alloc, 1, k).GadgetVector(base)

    A = Matrix(alloc, 1, k + 2)
    A.set(0, 0, RingPoly.constant(params, 1, EVALUATION))
    A.set(0, 1, a)
    for i in range(k):
        A.set(0, i + 2, g(0, i) - (a * r(0, i) + e(0, i)))
    return A, RLWETrapdoorPair(m_r=r, m_e=e)


def zsample_sigma_p(n: int, s: float, sigma: float,
                    trapdoor: RLWETrapdoorPair, draws) -> Matrix:
    """(reference ZSampleSigmaP, trapdoor-impl.h:77) perturbation vector
    with covariance s^2 I - sigma^2 T T^t, T = [[e],[r],[I]]."""
    t0 = trapdoor.m_e
    t1 = trapdoor.m_r
    k = t0.GetCols()
    params = t0(0, 0).params
    alloc = _zero_alloc(params)

    va = RingPoly(params, None, EVALUATION)
    vb = RingPoly(params, None, EVALUATION)
    vd = RingPoly(params, None, EVALUATION)
    for i in range(k):
        va = va + t0(0, i) * t0(0, i).Transpose()
        vb = vb + t1(0, i) * t0(0, i).Transpose()
        vd = vd + t1(0, i) * t1(0, i).Transpose()

    def to_field(p: RingPoly) -> Field2n:
        return Field2n.from_int_vector(p.centered())

    scalar = -s * s * sigma * sigma / (s * s - sigma * sigma)
    a = to_field(va).ScalarMult(scalar) + (s * s)
    b = to_field(vb).ScalarMult(scalar)
    d = to_field(vd).ScalarMult(scalar) + (s * s)
    a = a.SetFormat(EVALUATION)
    b = b.SetFormat(EVALUATION)
    d = d.SetFormat(EVALUATION)

    sigma_large = math.sqrt(s * s - sigma * sigma)
    p2_z = sample_integers(torch.zeros(n * k, dtype=torch.float64,
                                       device=params.device),
                           sigma_large, draws)
    p2 = [RingPoly.from_coeffs(params, p2_z[i * n:(i + 1) * n])
          .SetFormat(EVALUATION) for i in range(k)]

    tp2_0 = RingPoly(params, None, EVALUATION)
    tp2_1 = RingPoly(params, None, EVALUATION)
    for i in range(k):
        tp2_0 = tp2_0 + t0(0, i) * p2[i]
        tp2_1 = tp2_1 + t1(0, i) * p2[i]

    cf = -sigma * sigma / (s * s - sigma * sigma)
    c0 = to_field(tp2_0).ScalarMult(cf)
    c1 = to_field(tp2_1).ScalarMult(cf)

    p1_z = dgs.zsample_sigma_2x2(a, b, d, (c0, c1), draws)
    p1 = [RingPoly.from_coeffs(params, p1_z[i * n:(i + 1) * n])
          .SetFormat(EVALUATION) for i in range(2)]

    out = Matrix(alloc, k + 2, 1)
    for i in range(2):
        out.set(i, 0, p1[i])
    for i in range(k):
        out.set(i + 2, 0, p2[i])
    return out


def gauss_samp(n: int, k: int, A: Matrix, T: RLWETrapdoorPair, u: RingPoly,
               draws, base: int = 2, sigma: float | None = None) -> Matrix:
    """(reference GaussSamp, trapdoor.h:148) -> [k+2, 1] Matrix of RingPoly
    with A x = u mod q. `sigma` is unused, as in the JAX package (the
    reference's c = (base + 1) SIGMA is used)."""
    params = u.params
    c = (base + 1) * dgs.SIGMA
    s = dgs.spectral_bound(n, k, base)

    p_hat = zsample_sigma_p(n, s, c, T, draws)

    perturbed = (u - A.Mult(p_hat)(0, 0)).SetFormat(COEFFICIENT)
    z_bbi = dgs.gauss_samp_gq_arb_base(
        perturbed.data.long(), c, k, params.q, base, draws)

    z_hat = [RingPoly.from_coeffs(params, z_bbi[i]).SetFormat(EVALUATION)
             for i in range(k)]

    def dot(row: Matrix) -> RingPoly:
        acc = RingPoly(params, None, EVALUATION)
        for i in range(k):
            acc = acc + row(0, i) * z_hat[i]
        return acc

    out = Matrix(_zero_alloc(params), k + 2, 1)
    out.set(0, 0, p_hat(0, 0) + dot(T.m_e))
    out.set(1, 0, p_hat(1, 0) + dot(T.m_r))
    for i in range(k):
        out.set(i + 2, 0, p_hat(i + 2, 0) + z_hat[i])
    return out


def verify_preimage(A: Matrix, x: Matrix, u: RingPoly) -> bool:
    """Check A x = u mod q (reference UnitTestTrapdoor equality oracle)."""
    prod = A.Mult(x)(0, 0)
    return bool(torch.equal(prod.SetFormat(COEFFICIENT).data,
                            u.SetFormat(COEFFICIENT).data))
