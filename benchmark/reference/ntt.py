"""Modular arithmetic and the negacyclic NTT over prime towers, plain torch.

EVAL form is the port's convention (and OpenFHE's bit-reversed one): word
j of a tower holds the polynomial at psi^(2 brv(j) + 1), psi the 2N-th
root of unity that `root_of_unity` picks. Every word is an int64 below
2^31, so a product of two fits int64 exactly.

`Exact` multiplies in int64. `Float64` multiplies in float64, whose 53-bit
mantissa loses the low bits of products past 2^53: the control, the step a
later change might take to run modular products on floating-point units.
"""

from __future__ import annotations

import functools
import random

import numpy as np
import torch


class Exact:
    """Exact modular products in int64."""
    name = "int64"

    @staticmethod
    def mul(a, b, q):
        return torch.remainder(a * b, q)


class Float64:
    """Modular products rounded through float64 (the control)."""
    name = "float64"

    @staticmethod
    def mul(a, b, q):
        if isinstance(q, torch.Tensor):
            q = q.double()
        prod = torch.round(a.double() * b.double())
        return torch.remainder(prod, q).long()


def bitrev(n: int) -> np.ndarray:
    """brv(j) over log2(n) bits for j < n."""
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def root_of_unity(order: int, q: int) -> int:
    """A primitive `order`-th root of unity mod the prime q (order a power
    of two): the first candidate g^((q - 1) / order) with g drawn from a
    `random.Random` seeded by q and the order, as the port picks it. A
    candidate of power-of-two order is primitive when its order/2-th power
    is -1."""
    if (q - 1) % order:
        raise ValueError(f"{order} does not divide {q} - 1")
    cofactor = (q - 1) // order
    rng = random.Random(q * 0x9E3779B97F4A7C15 + order)
    for _ in range(10000):
        cand = pow(rng.randrange(2, q), cofactor, q)
        if cand != 1 and pow(cand, order // 2, q) == q - 1:
            return cand
    raise RuntimeError(f"no {order}-th root of unity mod {q}")


@functools.lru_cache(maxsize=None)
def _tower(q: int, n: int) -> tuple:
    """(psi^brv(j), psi^-brv(j)) for j < n as int64 numpy arrays, and
    n^-1 mod q."""
    psi = root_of_unity(2 * n, q)
    ipsi = pow(psi, -1, q)

    def powers(base):
        # base^(m + i) = base^i * base^m for each doubling m; q < 2^31
        out = np.ones(n, dtype=np.uint64)
        m, step = 1, base
        while m < n:
            out[m:2 * m] = out[:m] * np.uint64(step) % np.uint64(q)
            step = step * step % q
            m *= 2
        return out.astype(np.int64)[bitrev(n)]

    return powers(psi), powers(ipsi), pow(n, -1, q)


class Towers:
    """NTT tables of a tuple of primes at ring dimension n on a device."""

    def __init__(self, moduli, n: int, device):
        self.moduli = tuple(int(q) for q in moduli)
        self.n = n
        self.device = torch.device(device)
        tabs = [_tower(q, n) for q in self.moduli]
        as_t = lambda rows: torch.from_numpy(np.stack(rows)).to(self.device)
        self.psi = as_t([t[0] for t in tabs])
        self.ipsi = as_t([t[1] for t in tabs])
        self.ninv = torch.tensor([t[2] for t in tabs], dtype=torch.int64,
                                 device=self.device).view(-1, 1)
        self.q = torch.tensor(self.moduli, dtype=torch.int64,
                              device=self.device).view(-1, 1)

    def take(self, idx) -> "Towers":
        """The towers at the given indices, in that order."""
        sub = Towers.__new__(Towers)
        ix = torch.as_tensor(list(idx), dtype=torch.long, device=self.device)
        sub.moduli = tuple(self.moduli[i] for i in idx)
        sub.n, sub.device = self.n, self.device
        for name in ("psi", "ipsi", "ninv", "q"):
            setattr(sub, name, getattr(self, name)[ix])
        return sub


def fwd(x: torch.Tensor, t: Towers, ar=Exact) -> torch.Tensor:
    """Coefficients [..., k, n] (natural order) -> EVAL, int64."""
    n = t.n
    lead = tuple(x.shape[:-1])
    q = t.q.view(-1, 1, 1)
    y = x.long()
    m, half = 1, n
    while m < n:
        half //= 2
        ys = y.reshape(lead[:-1] + (lead[-1], m, 2, half))
        u = ys[..., 0, :]
        v = ar.mul(ys[..., 1, :], t.psi[:, m:2 * m, None], q)
        y = torch.stack([torch.remainder(u + v, q), torch.remainder(u - v, q)],
                        dim=-2).reshape(lead + (n,))
        m *= 2
    return y


def inv(x: torch.Tensor, t: Towers, ar=Exact) -> torch.Tensor:
    """EVAL [..., k, n] -> coefficients (natural order), int64."""
    n = t.n
    lead = tuple(x.shape[:-1])
    q = t.q.view(-1, 1, 1)
    y = x.long()
    m, half = n // 2, 1
    while m >= 1:
        ys = y.reshape(lead[:-1] + (lead[-1], m, 2, half))
        u, v = ys[..., 0, :], ys[..., 1, :]
        lo = torch.remainder(u + v, q)
        hi = ar.mul(torch.remainder(u - v, q), t.ipsi[:, m:2 * m, None], q)
        y = torch.stack([lo, hi], dim=-2).reshape(lead + (n,))
        m //= 2
        half *= 2
    return ar.mul(y, t.ninv, t.q)


def eval_gather(n: int, g: int) -> np.ndarray:
    """The automorphism X -> X^g in EVAL form: out[j] = in[idx[j]]. Word j
    holds the value at psi^e, e = 2 brv(j) + 1; sigma_g's value there is
    the input's at psi^(g e), held by word brv((g e mod 2n - 1) / 2)."""
    rev = bitrev(n)
    e = 2 * rev + 1
    return rev[((g * e) % (2 * n) - 1) // 2]
