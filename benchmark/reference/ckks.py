"""CKKS-RNS with HYBRID key switching, plain torch int64.

The operations the CKKS cells time, from their definitions (OpenFHE's
keyswitch-hybrid.cpp and the rescale of rns-leveledshe.cpp):

* a ciphertext at a level with L Q towers is a pair of [L, N] EVAL words;
* the key switch extends each of the digit's own towers to Q_L P by the
  fast base conversion (each word x_i (D/d_i)^-1 mod d_i times D/d_i,
  summed mod the target), takes the inner product with the key's digits
  and divides by P the same way (ApproxModDown);
* digit j covers Q towers [j alpha, min((j + 1) alpha, L)), alpha =
  ceil(kQ / digits), as many digits as the level has towers for;
* the key of s_old -> s has, per digit, (b_j, a_j) over all of Q P with
  b_j = e_j - a_j s + P s_old on digit j's towers, from the uniform a_j
  and the small e_j the benchmark draws;
* the rescale divides by the last tower with rounding: floor((c + h) /
  q_l) for h = floor(q_l / 2);
* a hoisted rotation permutes the extended digits of c1 and adds the
  rotated c0 after the mod-down.
"""

from __future__ import annotations

import functools
import math

import torch

from . import ntt
from .ntt import Exact


class Chain:
    """The Q and P towers of one configuration on a device."""

    def __init__(self, moduli_q, moduli_p, n: int, digits: int, device,
                 ar=Exact):
        self.mq, self.mp = tuple(moduli_q), tuple(moduli_p)
        self.n, self.ar = n, ar
        self.kq, self.kp = len(self.mq), len(self.mp)
        self.alpha = -(-self.kq // digits)
        self.digits_full = digits
        self.towers = ntt.Towers(self.mq + self.mp, n, device)
        self.device = self.towers.device

    # -- towers ---------------------------------------------------------
    def q_idx(self, lo: int, hi: int) -> list:
        return list(range(lo, hi))

    def p_idx(self) -> list:
        return list(range(self.kq, self.kq + self.kp))

    @functools.lru_cache(maxsize=None)
    def sub(self, idx: tuple) -> ntt.Towers:
        return self.towers.take(idx)

    def digit_ranges(self, size: int) -> list:
        count = min(-(-size // self.alpha), self.digits_full)
        return [(j * self.alpha, min((j + 1) * self.alpha, size))
                for j in range(count)]

    # -- RNS tools ------------------------------------------------------
    @functools.lru_cache(maxsize=None)
    def _conv_consts(self, src: tuple, dst: tuple):
        mods = self.mq + self.mp
        fr = [mods[i] for i in src]
        to = [mods[i] for i in dst]
        big = math.prod(fr)
        hat = [big // b for b in fr]
        hinv = torch.tensor([pow(h % b, -1, b) for h, b in zip(hat, fr)],
                            dtype=torch.int64, device=self.device)
        mat = torch.tensor([[h % d for d in to] for h in hat],
                           dtype=torch.int64, device=self.device)
        return hinv.view(-1, 1), mat

    def convert(self, x: torch.Tensor, src: tuple, dst: tuple):
        """Fast base conversion of coefficients x [len(src), N] (residues
        mod the src towers) to the dst towers: sum_i [x_i (B/b_i)^-1]_{b_i}
        (B/b_i) mod d_j."""
        ar = self.ar
        hinv, mat = self._conv_consts(src, dst)
        qs = self.sub(src).q
        qd = self.sub(dst).q
        y = ar.mul(x, hinv, qs)
        out = torch.zeros((len(dst), x.shape[-1]), dtype=torch.int64,
                          device=self.device)
        for i in range(len(src)):
            out = torch.remainder(
                out + ar.mul(y[i][None, :], mat[i][:, None], qd), qd)
        return out

    def fwd(self, x, idx):
        return ntt.fwd(x, self.sub(tuple(idx)), self.ar)

    def inv(self, x, idx):
        return ntt.inv(x, self.sub(tuple(idx)), self.ar)

    # -- key switching --------------------------------------------------
    def mod_up(self, c: torch.Tensor) -> list:
        """The extended digits of c [L, N] EVAL, each [L + kP, N] EVAL over
        Q_L then P."""
        size = c.shape[-2]
        digits = []
        for lo, hi in self.digit_ranges(size):
            own = tuple(range(lo, hi))
            rest = tuple(self.q_idx(0, lo) + self.q_idx(hi, size)
                         + self.p_idx())
            conv = self.fwd(self.convert(self.inv(c[lo:hi], own), own, rest),
                            rest)
            digits.append(torch.cat([conv[:lo], c[lo:hi].long(), conv[lo:]]))
        return digits

    def key_rows(self, key: torch.Tensor, size: int) -> torch.Tensor:
        """A key [digits, kQ + kP, N] cut to the level's Q_L P rows."""
        return torch.cat([key[:, :size], key[:, self.kq:]], dim=1)

    def inner(self, digits: list, kb, ka, size: int):
        """(sum_j d_j b_j, sum_j d_j a_j) over Q_L P."""
        idx = tuple(self.q_idx(0, size) + self.p_idx())
        q = self.sub(idx).q
        kb, ka = self.key_rows(kb, size), self.key_rows(ka, size)
        acc0 = acc1 = 0
        for j, d in enumerate(digits):
            acc0 = torch.remainder(acc0 + self.ar.mul(d, kb[j].long(), q), q)
            acc1 = torch.remainder(acc1 + self.ar.mul(d, ka[j].long(), q), q)
        return acc0, acc1

    def mod_down(self, x: torch.Tensor, size: int) -> torch.Tensor:
        """(x - [x]_P) / P over Q_L for x [L + kP, N] EVAL."""
        qi, pi = tuple(self.q_idx(0, size)), tuple(self.p_idx())
        conv = self.fwd(self.convert(self.inv(x[size:], pi), pi, qi), qi)
        q = self.sub(qi).q
        big_p = math.prod(self.mp)
        pinv = torch.tensor([pow(big_p % m, -1, m) for m in self.mq[:size]],
                            dtype=torch.int64, device=self.device).view(-1, 1)
        return self.ar.mul(torch.remainder(x[:size] - conv, q), pinv, q)

    def key_switch(self, digits: list, kb, ka, size: int):
        return tuple(self.mod_down(e, size)
                     for e in self.inner(digits, kb, ka, size))

    # -- ciphertext operations -----------------------------------------
    def q_of(self, size: int) -> torch.Tensor:
        return self.sub(tuple(self.q_idx(0, size))).q

    def eval_mult(self, a, b, kb, ka):
        """Tensor product of (a0, a1) and (b0, b1), relinearized."""
        size = a[0].shape[-2]
        q, mul = self.q_of(size), self.ar.mul
        a0, a1, b0, b1 = (t.long() for t in (*a, *b))
        c0 = mul(a0, b0, q)
        c1 = torch.remainder(mul(a0, b1, q) + mul(a1, b0, q), q)
        d0, d1 = self.key_switch(self.mod_up(mul(a1, b1, q)), kb, ka, size)
        return torch.remainder(c0 + d0, q), torch.remainder(c1 + d1, q)

    def rescale(self, ct):
        """Each element divided by its last tower, rounded."""
        out = []
        for c in ct:
            size = c.shape[-2]
            ql = self.mq[size - 1]
            h = ql >> 1
            u = self.inv(c[size - 1:size], (size - 1,))
            ushift = torch.remainder(u + h, ql)
            rest = tuple(self.q_idx(0, size - 1))
            q = self.sub(rest).q
            w = self.fwd(torch.remainder(ushift - h, q), rest)
            qlinv = torch.tensor([pow(ql, -1, m) for m in self.mq[:size - 1]],
                                 dtype=torch.int64,
                                 device=self.device).view(-1, 1)
            out.append(self.ar.mul(torch.remainder(c[:size - 1].long() - w, q),
                                   qlinv, q))
        return tuple(out)

    def automorph(self, x: torch.Tensor, g: int) -> torch.Tensor:
        idx = torch.from_numpy(ntt.eval_gather(self.n, g)).to(self.device)
        return torch.index_select(x, -1, idx)

    def fast_rotation(self, ct, digits: list, g: int, kb, ka):
        """A rotation of ct by the automorphism g on its hoisted digits."""
        size = ct[0].shape[-2]
        q = self.q_of(size)
        rot = [self.automorph(d, g) for d in digits]
        d0, d1 = self.key_switch(rot, kb, ka, size)
        c0 = self.automorph(ct[0].long(), g)
        return torch.remainder(c0 + d0, q), d1

    def mult_plain(self, ct, pt):
        q = self.q_of(ct[0].shape[-2])
        return tuple(self.ar.mul(c.long(), pt.long(), q) for c in ct)

    def add(self, a, b):
        q = self.q_of(a[0].shape[-2])
        return tuple(torch.remainder(x.long() + y.long(), q)
                     for x, y in zip(a, b))

    # -- keys -------------------------------------------------------------
    def lift(self, small: torch.Tensor) -> torch.Tensor:
        """A small signed polynomial [N] in EVAL over all of Q P."""
        return self.fwd(torch.remainder(small.long()[None, :],
                                        self.towers.q), range(self.kq
                                                              + self.kp))

    def keygen(self, s_old, s_new, draws):
        """The key switching s_old -> s_new (EVAL over Q P) from the draws
        (a_j [kQ + kP, N] uniform EVAL, e_j [N] small) of each digit:
        (b [digits, kQ + kP, N], a)."""
        q = self.towers.q
        big_p = math.prod(self.mp)
        pmod = torch.tensor([big_p % m for m in self.mq] + [0] * self.kp,
                            dtype=torch.int64, device=self.device).view(-1, 1)
        ps_old = self.ar.mul(s_old, pmod, q)
        rows = torch.arange(self.kq + self.kp, device=self.device)[:, None]
        bs, as_ = [], []
        for j in range(self.digits_full):
            a, e = draws[2 * j].long(), draws[2 * j + 1]
            b = torch.remainder(self.lift(e) - self.ar.mul(a, s_new, q), q)
            lo, hi = j * self.alpha, min((j + 1) * self.alpha, self.kq)
            mask = (rows >= lo) & (rows < hi)
            bs.append(torch.where(mask, torch.remainder(b + ps_old, q), b))
            as_.append(a)
        return torch.stack(bs), torch.stack(as_)
