"""Four-step negacyclic NTT on the per-tower modular matmul (kernel l).

Counterpart of `openfhe_tpu/ops/ntt4step.py` (reference analog: the
transformnat-impl.h butterflies): the size-N transform as two modular
matrix products over an [R, C] view of each row (R = 2^ceil(log2(N)/2),
C = N/R) with a twiddle between them (Bailey's 4-step). The bit-reversals
that EVAL order needs are folded into the matrices' rows at table-build
time, so the words equal `ops/ntt.py`'s.

The matrices are raw residues (the JAX package's int8 limb form of them is
the MXU's number scheme and has no counterpart here); the twiddle is a
Shoup multiply in plain torch, as the JAX package leaves it to XLA.
`ops.ntt.ntt_fwd` does not dispatch here: `csrc/ntt.cu` stays the port's
NTT, and this transform serves the sharded NTT of `parallel/ntt_sharded.py`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openfhe_tpu_torch.lattice.basis import (Basis, _bitrev_indices,
                                             _power_table)
from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.math import nbtheory
from openfhe_tpu_torch.ops.modmatmul import mod_matmul


def _shoup_np(c: np.ndarray, moduli) -> np.ndarray:
    q = np.array(moduli, np.uint64)[:, None, None]
    return ((c.astype(np.uint64) << np.uint64(32)) // q).astype(np.uint32)


def _power_table_np(base: int, count: int, q: int) -> np.ndarray:
    return _power_table(base, count, q).astype(np.int64)


def split(n: int) -> tuple:
    """(R, C) of the [R, C] view of a ring of dimension n."""
    logn = n.bit_length() - 1
    r = 1 << ((logn + 1) // 2)
    return r, n // r


@functools.lru_cache(maxsize=None)
def _tower_tables_raw(q: int, n: int):
    """Raw uint32 4-step matrices for one (modulus, ring) pair.

    Returns (wr, wc, wri, wci, tw, twi):
      wr  [R, R] rows d (bit-rev), cols a     — stage-1 forward weights
      wc  [C, C] rows cc (bit-rev), cols b    — stage-2 forward weights
      wri [R, R] rows a, cols d' (bit-rev)    — stage-B inverse weights
      wci [C, C] rows b, cols cc' (bit-rev)   — stage-A inverse weights
      tw/twi [R, C] indexed [d, b]            — mid twiddles (+ fold-ins)
    """
    r, c = split(n)
    br_r = _bitrev_indices(r)
    br_c = _bitrev_indices(c)
    psi = nbtheory.root_of_unity(2 * n, q)
    w = pow(psi, 2, q)
    winv = pow(w, -1, q)
    psiinv = pow(psi, -1, q)
    rinv = pow(r, -1, q)
    cinv = pow(c, -1, q)
    d_i = np.arange(r)
    a_i = np.arange(r)
    c_i = np.arange(c)
    b_i = np.arange(c)
    # forward: S1 = WR @ X ; S2 = S1 * TW ; Y = S2 @ WC^T
    # WR[d, a] = w^(C d a) * psi^(a C); WC[cc, b] = w^(R cc b);
    # TW[d, b] = w^(d b) * psi^b; rows d and cc bit-reversed for layout
    wp = _power_table_np(w, n, q)
    pp = _power_table_np(psi, 2 * n, q)
    wr = ((wp[(c * np.outer(d_i, a_i)) % n]
           * pp[(a_i * c) % (2 * n)][None, :]) % q)[br_r]
    wc = wp[(r * np.outer(c_i, b_i)) % n][br_c]
    tw = ((wp[np.outer(d_i, b_i) % n]
           * pp[b_i % (2 * n)][None, :]) % q)[br_r]
    # inverse: S2 = Y @ (WC^-1)^T ; S1 = S2 * TW^-1 ; X = WR^-1 @ S1
    wip = _power_table_np(winv, n, q)
    pip = _power_table_np(psiinv, 2 * n, q)
    wci = ((wip[(r * np.outer(b_i, c_i)) % n] * cinv) % q)[:, br_c]
    wri = ((wip[(c * np.outer(a_i, d_i)) % n]
            * (pip[(a_i * c) % (2 * n)] * rinv % q)[:, None]) % q)[:, br_r]
    twi = ((wip[np.outer(d_i, b_i) % n]
            * pip[b_i % (2 * n)][None, :]) % q)[br_r]
    return (wr.astype(np.uint32), wc.astype(np.uint32),
            wri.astype(np.uint32), wci.astype(np.uint32),
            tw.astype(np.uint32), twi.astype(np.uint32))


@functools.lru_cache(maxsize=None)
def _tables(moduli: tuple, n: int) -> dict:
    """Per-chain numpy stacks of the per-tower tables."""
    per = [_tower_tables_raw(int(q), n) for q in moduli]
    stack = lambda i: np.stack([p[i] for p in per])
    tw, twi = stack(4), stack(5)
    return dict(wr=stack(0), wc=stack(1), wri=stack(2), wci=stack(3),
                tw=tw, tw_sh=_shoup_np(tw, moduli),
                twi=twi, twi_sh=_shoup_np(twi, moduli))


@functools.lru_cache(maxsize=16)
def dev_tables(moduli: tuple, n: int, device: str) -> dict:
    """The tables of `_tables` as int32 tensors on `device`, with the
    moduli `q` [k, 1]."""
    out = {k: mo.u32_tensor(v, device) for k, v in _tables(moduli, n).items()}
    out["q"] = mo.u32_tensor(np.array(moduli, np.uint64).reshape(-1, 1),
                             device)
    return out


def ntt_fwd_4step(x: torch.Tensor, b: Basis) -> torch.Tensor:
    """COEFF -> EVAL (bit-reversed), the words of ops.ntt.ntt_fwd;
    x [..., k, N] int32."""
    t = dev_tables(b.moduli, b.ring_dim, str(x.device))
    r, c = split(b.ring_dim)
    k, n = x.shape[-2], x.shape[-1]
    lead = tuple(x.shape[:-2])
    batch = int(np.prod(lead)) if lead else 1
    q4 = t["q"].view(k, 1, 1, 1)
    # [B, k, R, C] -> tower-major with the batch folded into the columns
    xx = x.reshape(batch, k, r, c).permute(1, 2, 0, 3).reshape(k, r,
                                                               batch * c)
    s1 = mod_matmul(t["wr"], xx.contiguous(), t["q"]).view(k, r, batch, c)
    s2 = mo.mul_mod_shoup(s1, t["tw"][:, :, None, :],
                          t["tw_sh"][:, :, None, :], q4)
    # second stage along C: [k, C, B * R]
    s2t = s2.permute(0, 3, 2, 1).reshape(k, c, batch * r)
    s3 = mod_matmul(t["wc"], s2t.contiguous(), t["q"])
    out = s3.view(k, c, batch, r).permute(2, 0, 3, 1)
    return out.reshape(lead + (k, n))


def ntt_inv_4step(x: torch.Tensor, b: Basis) -> torch.Tensor:
    """EVAL (bit-reversed) -> COEFF, the words of ops.ntt.ntt_inv;
    x [..., k, N] int32."""
    t = dev_tables(b.moduli, b.ring_dim, str(x.device))
    r, c = split(b.ring_dim)
    k, n = x.shape[-2], x.shape[-1]
    lead = tuple(x.shape[:-2])
    batch = int(np.prod(lead)) if lead else 1
    q4 = t["q"].view(k, 1, 1, 1)
    # EVAL index j = d' * C + c': stage A contracts over c'
    y = x.reshape(batch, k, r, c).permute(1, 3, 0, 2).reshape(k, c,
                                                              batch * r)
    s2 = mod_matmul(t["wci"], y.contiguous(), t["q"])       # [k, C, B * R]
    s2 = s2.view(k, c, batch, r).permute(0, 3, 2, 1)        # [k, R, B, C]
    s1 = mo.mul_mod_shoup(s2, t["twi"][:, :, None, :],
                          t["twi_sh"][:, :, None, :], q4)
    xx = mod_matmul(t["wri"], s1.reshape(k, r, batch * c).contiguous(),
                    t["q"])
    out = xx.view(k, r, batch, c).permute(2, 0, 1, 3)
    return out.reshape(lead + (k, n))
