"""Arbitrary-cyclotomic transforms via Bluestein's chirp-z FFT.

Counterpart of `openfhe_tpu/math/cyclotomic.py` (reference analog:
BluesteinFFTNat / ChineseRemainderTransformArbNat, transformnat.h), the
CRT transform for rings Z_q[x]/Phi_m(x) of arbitrary (non-power-of-two)
cyclotomic order m. The public functions take and return lists of
Python ints, as the JAX package's do, and give its words.

  * Forward transform = evaluate a (deg < totient(m)) at the primitive
    m-th roots of unity omega^i, i in U(m): Bluestein's chirp-z of
    length m, X_k = beta^{k^2} sum_j (a_j beta^{j^2}) beta^{-(k-j)^2}
    with beta^2 = omega, one cyclic convolution of power-of-two length
    `big` >= 2m - 1.
  * The convolution is exact over the integers and runs on the card: the
    two zero-padded sequences' linear convolution is their negacyclic
    product in a ring of 2 `big` words (no wrap: its degree stays below
    2 `big` - 1), one `ops/ntt` forward transform of both and one
    inverse, over primes p = 1 mod 4 `big` below 2^31 whose product
    bounds the result; folding the product mod x^big - 1 in each residue
    gives the cyclic convolution mod p, and Garner's recombination (host
    Python ints) the integers. The JAX package instead runs a cyclic NTT
    of length `big` over 30-bit primes on the host. On the card the
    transforms are kernel m for 2 `big` <= 2048 and kernels a/b above;
    on the CPU their plain twins.
  * The O(m) chirp twists before and after, and the reduction mod
    Phi_m(x) of the inverse, stay host Python ints, as in JAX.
  * Inverse transform: zero-fill the non-unit slots, full m-point inverse
    chirp-z, then reduce mod Phi_m(x) (the length-m inverse b agrees with
    a at every root of Phi_m, so Phi_m | (b - a)).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from openfhe_tpu_torch._device import resolve_device
from openfhe_tpu_torch.lattice.basis import make_basis
from openfhe_tpu_torch.math import nbtheory as nb
from openfhe_tpu_torch.ops import ntt


# ---------------------------------------------------------------------------
# Cyclotomic polynomial (host, exact): Phi_m(x) over Z.
# Reference: GetCyclotomicPolynomial (src/core/lib/math/nbtheory.cpp).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def cyclotomic_poly(m: int) -> tuple:
    """Integer coefficients of Phi_m(x), low-to-high, via
    x^m - 1 = prod_{d | m} Phi_d(x) and exact polynomial division."""
    if m == 1:
        return (-1, 1)
    num = [0] * (m + 1)
    num[0], num[m] = -1, 1
    for d in range(1, m):
        if m % d == 0:
            num = _polydiv_exact(num, list(cyclotomic_poly(d)))
    return tuple(num)


def _polydiv_exact(num: list, den: list) -> list:
    """Exact division of integer polynomials (remainder must be 0)."""
    num = list(num)
    out = [0] * (len(num) - len(den) + 1)
    for i in range(len(out) - 1, -1, -1):
        c = num[i + len(den) - 1] // den[-1]
        out[i] = c
        if c:
            for j, dj in enumerate(den):
                num[i + j] -= c * dj
    if any(num[:len(den) - 1]):
        raise ArithmeticError("non-exact cyclotomic division")
    return out


# ---------------------------------------------------------------------------
# Exact cyclic convolution through the negacyclic NTT on the card.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _conv_primes(big_len: int, bound_bits: int) -> tuple:
    """Primes p = 1 mod 4 big_len below 2^31 (NTT-friendly for the ring
    of 2 big_len words) whose product exceeds 2^bound_bits."""
    primes, total = [], 0
    p = 1 << 31
    while total < bound_bits + 1:
        p = nb.previous_prime(p, 4 * big_len)
        primes.append(p)
        total += p.bit_length() - 1
    return tuple(primes)


@functools.lru_cache(maxsize=16)
def _conv_basis(primes: tuple, ring: int, device: torch.device):
    return make_basis(primes, ring, device=device)


def _residues(vals: list, primes: tuple, ring: int) -> np.ndarray:
    """[k, ring] residues of nonnegative ints, zero-padded past len(vals)."""
    out = np.zeros((len(primes), ring), np.int32)
    if max(vals) < 1 << 62:
        v = np.array(vals, np.int64)
        out[:, :len(vals)] = v[None, :] % np.array(primes, np.int64)[:, None]
        return out
    v = np.array(vals, object)
    for i, p in enumerate(primes):
        out[i, :len(vals)] = (v % p).astype(np.int64)
    return out


def _cyclic_conv_exact(a: list, b: list, big_len: int, bound_bits: int,
                       device: torch.device) -> list:
    """Exact integer cyclic convolution of length big_len (a power of two)
    of two lists of nonnegative ints, each result < 2^bound_bits."""
    primes = _conv_primes(big_len, bound_bits)
    ring = 2 * big_len
    basis = _conv_basis(primes, ring, device)
    x = torch.from_numpy(np.stack([_residues(a, primes, ring),
                                   _residues(b, primes, ring)])).to(device)
    f = ntt.ntt_fwd(x, basis)                        # [2, k, ring]
    q = basis.q.long()
    lin = ntt.ntt_inv((f[0].long() * f[1].long() % q).int(), basis)
    cyc = ((lin[:, :big_len].long() + lin[:, big_len:]) % q).cpu().numpy()
    # Garner's recombination over the primes, vectorised on Python ints
    out = cyc[0].astype(object)
    mod = primes[0]
    for p, r in zip(primes[1:], cyc[1:]):
        t = (r.astype(object) - out) * nb.mod_inverse(mod % p, p) % p
        out = out + mod * t
        mod *= p
    return out.tolist()


# ---------------------------------------------------------------------------
# Bluestein chirp-z DFT of arbitrary length m mod q.
# ---------------------------------------------------------------------------

def bluestein_fft(x, q: int, root: int, inverse: bool = False,
                  device=None) -> list:
    """Length-m DFT mod q at the m-th root `root` (Bluestein chirp-z,
    reference BluesteinFFTNat::ForwardTransform), its convolution on
    `device` (the GPU when None; raises when there is none).

    x: m integers mod q. Requires q = 1 mod 2m, for the 2m-th root beta
    with beta^2 = root. Exact for any such q."""
    dev = resolve_device(device)
    m = len(x)
    w = nb.mod_inverse(root, q) if inverse else root
    beta = _beta_for(q, m, w)
    big = 1 << (2 * m - 1).bit_length()
    # w^{jk} = beta^{j^2 + k^2 - (k-j)^2}:
    #   X_k = beta^{k^2} * sum_j (x_j beta^{j^2}) * ibeta^{(k-j)^2}
    ibeta = nb.mod_inverse(beta, q)
    u = [0] * big
    for j in range(m):
        u[j] = int(x[j]) % q * pow(beta, j * j, q) % q
    v = [0] * big
    for t in range(-(m - 1), m):
        v[t % big] = pow(ibeta, t * t, q)
    bound = (2 * m * (q - 1) * (q - 1)).bit_length()
    conv = _cyclic_conv_exact(u, v, big, bound, dev)
    out = [conv[k] % q * pow(beta, k * k, q) % q for k in range(m)]
    if inverse:
        minv = nb.mod_inverse(m, q)
        out = [val * minv % q for val in out]
    return out


@functools.lru_cache(maxsize=None)
def _beta_for(q: int, m: int, w: int) -> int:
    """A 2m-th root beta mod q with beta^2 = w (w an m-th root)."""
    if (q - 1) % (2 * m) != 0:
        raise ValueError(f"q={q} must be 1 mod 2m for Bluestein (m={m})")
    beta = nb.root_of_unity(2 * m, q)
    # beta^2 is SOME primitive m-th root; find e odd with beta^{2e} = w
    for e in range(1, 2 * m, 2):
        if math.gcd(e, 2 * m) == 1 and pow(beta, 2 * e, q) == w:
            return pow(beta, e, q)
    # w may be non-primitive (inverse of power): fall back to a sqrt search
    for e in range(2 * m):
        if pow(beta, 2 * e, q) == w:
            return pow(beta, e, q)
    raise ValueError("no square root of the DFT root found")


# ---------------------------------------------------------------------------
# CRT transform for Z_q[x]/Phi_m(x)  (ChineseRemainderTransformArbNat)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _units(m: int) -> tuple:
    return tuple(i for i in range(m) if math.gcd(i, m) == 1)


def forward_transform_arb(coeffs, q: int, m: int, device=None) -> list:
    """COEFF -> EVAL for arbitrary cyclotomic order m: values a(omega^i)
    for i in U(m), omega a primitive m-th root mod q (reference
    ChineseRemainderTransformArbNat::ForwardTransform)."""
    t = nb.totient(m)
    a = list(coeffs) + [0] * (m - len(coeffs))
    if len(coeffs) > t:
        raise ValueError("input degree must be < totient(m)")
    omega = nb.root_of_unity(m, q)
    full = bluestein_fft(a, q, omega, device=device)
    return [full[i] for i in _units(m)]


def inverse_transform_arb(values, q: int, m: int, device=None) -> list:
    """EVAL -> COEFF: zero-extend to all m slots, inverse chirp-z, then
    reduce mod Phi_m(x) (reference InverseTransform + Drop)."""
    units = _units(m)
    t = len(units)
    if len(values) != t:
        raise ValueError("need totient(m) evaluation values")
    full = [0] * m
    for i, u in enumerate(units):
        full[u] = int(values[i]) % q
    omega = nb.root_of_unity(m, q)
    b = bluestein_fft(full, q, omega, inverse=True, device=device)
    # reduce mod Phi_m over Z_q, a row of Phi_m's coefficients a step
    # (int64 while q < 2^31 keeps every product exact, else Python ints)
    dtype = np.int64 if q < 1 << 31 else object
    phi = np.array([c % q for c in cyclotomic_poly(m)], dtype)
    inv_lead = nb.mod_inverse(int(phi[-1]), q)   # Phi_m is monic: == 1
    b = np.array(b, dtype)
    width = len(phi)
    for i in range(m - 1, t - 1, -1):
        c = int(b[i]) * inv_lead % q
        if c:
            b[i - width + 1:i + 1] = (b[i - width + 1:i + 1] - c * phi) % q
    return [int(v) % q for v in b[:t]]


def multiply_arb(a, b, q: int, m: int, device=None) -> list:
    """Multiplication in Z_q[x]/Phi_m(x) through the CRT transform: two
    forward transforms, the slot products and one inverse."""
    fa = forward_transform_arb(a, q, m, device)
    fb = forward_transform_arb(b, q, m, device)
    return inverse_transform_arb([x * y % q for x, y in zip(fa, fb)], q, m,
                                 device)
