"""FHEW/CGGI gate bootstrapping with GINX, plain torch int64.

A gate as OpenFHE's binfhe-base-scheme.cpp EvalBinGate defines it, from the
benchmark's inputs and keys:

* the two LWE inputs (n, q) are added;
* the accumulator starts as (0, NTT(m)), m the gate's test polynomial over
  q / 2 coefficients at stride 2N / q;
* each of the n steps (rgsw-acc-cggi.cpp AddToAccCGGI) takes the signed
  base-B_g digits of both accumulator halves in coefficient form (the
  first digit dropped: approximate gadget), their NTTs times the two CMUX
  keys of the coordinate, times X^(+-idx) - 1, added on;
* the sample is extracted (a(X) -> a(X^-1), b the constant coefficient plus
  Q/8 + 1), switched to q_KS, key-switched to the LWE key and switched to
  q: each switch rounds (v q_to + floor(q_from / 2)) / q_from.

The bootstrapping key is [n, 2, d2, 2, N] (per coordinate the keys of
s_i = 1 and s_i = -1, gadget rows, (a, b), EVAL mod Q); the switching key
(a [N, B_ks, d_ks, n], b [N, B_ks, d_ks]) mod q_KS.
"""

from __future__ import annotations

import torch

from . import ntt
from .ntt import Exact

# rgsw-cryptoparameters.cpp's gate offsets in eighths of q
GATE_EIGHTHS = {"OR": 5, "AND": 7, "NOR": 1, "NAND": 3}
KS_CHUNK = 16     # gates a key-switch gather holds


def digits_for(modulus: int, base: int) -> int:
    """The base-`base` digits that cover [0, modulus)."""
    d, span = 0, 1
    while span < modulus:
        span *= base
        d += 1
    return d


class Ginx:
    """One GINX parameter set on a device."""

    def __init__(self, n, ring, q, big_q, base_g, q_ks, base_ks, device,
                 ar=Exact):
        self.n, self.ring, self.q, self.big_q = n, ring, q, big_q
        self.base_g, self.q_ks, self.base_ks = base_g, q_ks, base_ks
        self.g_bits = base_g.bit_length() - 1
        self.digits_g = digits_for(big_q, base_g)
        self.d2 = 2 * (self.digits_g - 1)
        self.d_ks = digits_for(q_ks, base_ks)
        self.ar = ar
        self.t = ntt.Towers([big_q], ring, device)
        self.device = self.t.device
        psi = ntt.root_of_unity(2 * ring, big_q)
        pows = [1] * (2 * ring)
        for i in range(1, 2 * ring):
            pows[i] = pows[i - 1] * psi % big_q
        self.psi_pow = torch.tensor(pows, dtype=torch.int64,
                                    device=self.device)
        self.exps = torch.from_numpy(2 * ntt.bitrev(ring) + 1).to(self.device)

    def fwd(self, x):
        return ntt.fwd(x.unsqueeze(-2), self.t, self.ar).squeeze(-2)

    def inv(self, x):
        return ntt.inv(x.unsqueeze(-2), self.t, self.ar).squeeze(-2)

    def test_vector(self, b: torch.Tensor, gates) -> torch.Tensor:
        """The test polynomial [G, N] of each gate's summed b."""
        q, big_q, half = self.q, self.big_q, self.q >> 1
        q1 = torch.tensor([GATE_EIGHTHS[g] * (q >> 3) for g in gates],
                          dtype=torch.int64, device=self.device)[:, None]
        q2 = torch.remainder(q1 + half, q)
        swap = q1 >= q2
        lb, ub = torch.where(swap, q2, q1), torch.where(swap, q1, q2)
        q2p = big_q // 8 + 1
        lv = torch.where(swap, q2p, big_q - q2p)
        uv = torch.where(swap, big_q - q2p, q2p)
        bi = torch.remainder(b[:, None] - torch.arange(half,
                                                       device=self.device), q)
        vals = torch.where((bi >= lb) & (bi < ub), lv, uv)
        m = torch.zeros((b.shape[0], self.ring), dtype=torch.int64,
                        device=self.device)
        m[:, ::self.ring // half] = vals
        return m

    def digits(self, c: torch.Tensor) -> torch.Tensor:
        """Signed base-B_g digits of coefficients c [G, 2, N] mod Q, the
        first dropped, as residues [G, d2, N] (digit-major, then half)."""
        big_q, g = self.big_q, self.g_bits
        half = 1 << (g - 1)
        d = torch.where(c >= big_q >> 1, c - big_q, c)
        rows = []
        for k in range(self.digits_g):
            r = ((d & ((1 << g) - 1)) ^ half) - half
            d = (d - r) >> g
            if k:
                rows.append(torch.remainder(r, big_q))
        return torch.stack(rows, dim=1).reshape(c.shape[0], self.d2,
                                                self.ring)

    def step(self, acc, key, ix):
        """One GINX step on acc [G, 2, N] EVAL: key [2, d2, 2, N] of the
        coordinate, ix [G] its monomial exponent."""
        big_q, mul = self.big_q, self.ar.mul
        dct = self.fwd(self.digits(self.inv(acc)))          # [G, d2, N]
        two_n = 2 * self.ring
        out = acc
        for k, t in ((0, ix), (1, torch.remainder(-ix, two_n))):
            mono = self.psi_pow[torch.remainder(t[:, None] * self.exps,
                                                two_n)] - 1   # [G, N]
            for c in range(2):
                s = 0
                for r in range(self.d2):
                    s = torch.remainder(
                        s + mul(dct[:, r], key[k, r, c].long(), big_q),
                        big_q)
                out = out.clone() if out is acc else out
                out[:, c] = torch.remainder(
                    out[:, c] + mul(s, torch.remainder(mono, big_q), big_q),
                    big_q)
        return out

    def blind_rotate(self, m, a, bt_key):
        """acc = (0, NTT(m)) rotated by the LWE vectors a [G, n]."""
        acc = torch.stack([torch.zeros_like(m), self.fwd(m)], dim=1)
        idx = torch.remainder(self.q - a, self.q) * (2 * self.ring // self.q)
        for i in range(self.n):
            acc = self.step(acc, bt_key[i], idx[:, i])
        return acc

    def extract(self, acc):
        """The sample mod Q: a(X) -> a(X^-1), b the constant coefficient
        plus Q/8 + 1."""
        big_q, ring = self.big_q, self.ring
        p = self.inv(acc)
        rev = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.arange(ring - 1, 0, -1)]).to(self.device)
        a = p[:, 0][:, rev]
        a[:, 1:] = torch.remainder(-a[:, 1:], big_q)
        b = torch.remainder(p[:, 1, 0] + (big_q >> 3) + 1, big_q)
        return a, b

    @staticmethod
    def switch(v, q_from, q_to):
        return torch.remainder((v * q_to + (q_from >> 1)) // q_from, q_to)

    def key_switch(self, a, b, ks_a, ks_b):
        """(a, b) mod q_KS at dimension N to the LWE key at dimension n."""
        base, d, q = self.base_ks, self.d_ks, self.q_ks
        digs, at = [], a
        for _ in range(d):
            digs.append(at % base)
            at = at // base
        dig = torch.stack(digs, dim=-1)                         # [G, N, d]
        i = torch.arange(self.ring, device=self.device)[:, None]
        k = torch.arange(d, device=self.device)[None, :]
        flat = ((i * base + dig) * d + k).reshape(a.shape[0], -1)
        rows_a = ks_a.reshape(-1, ks_a.shape[-1])
        out_a = torch.cat([rows_a[flat[g:g + KS_CHUNK]].long().sum(1)
                           for g in range(0, flat.shape[0], KS_CHUNK)])
        out_b = ks_b.reshape(-1)[flat].long().sum(1)
        return torch.remainder(-out_a, q), torch.remainder(b - out_b, q)

    def gate(self, a1, b1, a2, b2, gates, bt_key, ks_a, ks_b):
        """EvalBinGate of each row: LWE inputs a [G, n], b [G] mod q ->
        the output (a [G, n], b [G]) mod q."""
        q = self.q
        a = torch.remainder(a1.long() + a2.long(), q)
        b = torch.remainder(b1.long() + b2.long(), q)
        acc = self.blind_rotate(self.test_vector(b, gates), a, bt_key)
        ea, eb = self.extract(acc)
        ea, eb = (self.switch(v, self.big_q, self.q_ks) for v in (ea, eb))
        ka, kb = self.key_switch(ea, eb, ks_a, ks_b)
        return self.switch(ka, self.q_ks, q), self.switch(kb, self.q_ks, q)


def decrypt(a, b, s, q: int, p: int = 4) -> torch.Tensor:
    """round(p (b - <a, s>) / q) mod p of LWE samples a [..., n], b [...]."""
    r = torch.remainder(b.long() - (a.long() * s.long()).sum(-1), q)
    return torch.remainder((r * p + q // 2) // q, p)
