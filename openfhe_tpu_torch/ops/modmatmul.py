"""Modular matmuls: the RNS base conversion (kernel k) and the per-tower
matrix product of the 4-step NTT (kernel l).

Counterpart of `openfhe_tpu/ops/modmatmul.py` (reference analogs
DCRTPolyImpl::ApproxSwitchCRTBasis and the transformnat-impl.h
butterflies):

    mod_matmul_rowmod: out[..., j, n] = sum_i y[..., i, n] * W[i, j] mod d_j
    mod_matmul:        out[t, d, b]   = sum_a W[t, d, a] * X[t, a, b] mod q_t

Words are canonical residues (int32 bit patterns); the row-modulus W comes
with Shoup companions. The JAX package's int8 limb form (`balanced_limbs_
host`, `_recombine`) exists for the TPU's matrix unit and has no
counterpart here. On a CUDA tensor each wrapper launches its kernel
(`csrc/rowmod.cu`, `csrc/modmatmul.cu`) or raises; on a CPU tensor it runs
its plain version.
"""

from __future__ import annotations

import torch

from openfhe_tpu_torch import _build

# mod_matmul's plain version sums 8-bit limbs of X times W in float64:
# every sum stays below 2^8 * 2^32 * A, exact (< 2^53) for A <= 2^13
LIMB_BITS = 8
LIMBS = 4
MAX_REF_DEPTH = 1 << 13
# the kernel's 64-bit sums of W * (16-bit half of X) stay exact to 2^15
MAX_DEPTH = 1 << 15


def mod_matmul_rowmod(y: torch.Tensor, w: torch.Tensor, w_sh: torch.Tensor,
                      d: torch.Tensor) -> torch.Tensor:
    """y [..., A, N] int32, w / w_sh [A, D] int32, d [D, 1] int32 moduli
    -> [..., D, N] int32."""
    if y.device.type == "cpu":
        return _mod_matmul_rowmod_ref(y, w, d)
    a_dim, d_dim = w.shape
    if y.device.type != "cuda":
        raise ValueError(f"mod_matmul_rowmod: no kernel for {y.device}")
    for name, t in (("w", w), ("w_sh", w_sh), ("d", d)):
        if t.device != y.device or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"mod_matmul_rowmod: {name} must be a "
                             f"contiguous int32 tensor on {y.device}")
    if y.dtype != torch.int32 or not y.is_contiguous():
        raise ValueError("mod_matmul_rowmod: y must be contiguous int32")
    if y.dim() < 2 or y.shape[-2] != a_dim or w_sh.shape != w.shape or \
            d.numel() != d_dim:
        raise ValueError(f"mod_matmul_rowmod: shapes y {tuple(y.shape)}, "
                         f"w {tuple(w.shape)}, d {tuple(d.shape)} disagree")
    n = y.shape[-1]
    lead = tuple(y.shape[:-2])
    out = torch.empty(lead + (d_dim, n), dtype=torch.int32, device=y.device)
    batch = y.numel() // (a_dim * n)
    _build.launch("rowmod", "mod_matmul_rowmod", y, w, w_sh, d, out, batch,
                  a_dim, d_dim, n)
    return out


def _mod_matmul_rowmod_ref(y: torch.Tensor, w: torch.Tensor,
                           d: torch.Tensor) -> torch.Tensor:
    """Plain int64 version of the kernel: one reduced product per input
    row (each < 2^62, the running sum < 2^63)."""
    q = d.long().view(-1, 1)                          # [D, 1]
    wl = w.long()
    yl = y.long()
    acc = torch.zeros(tuple(y.shape[:-2]) + (w.shape[1], y.shape[-1]),
                      dtype=torch.int64, device=y.device)
    for i in range(w.shape[0]):
        acc = torch.remainder(acc + yl[..., i:i + 1, :] * wl[i, :, None], q)
    return acc.int()


def mod_matmul(w: torch.Tensor, x: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """Per-tower (W @ X) mod q: w [k, D, A] and x [k, A, B] int32 words
    below 2^31, q [k, 1] int32 moduli -> [k, D, B] int32 (kernel l)."""
    if x.device.type == "cpu":
        return _mod_matmul_ref(w, x, q)
    if x.device.type != "cuda":
        raise ValueError(f"mod_matmul: no kernel for device {x.device}")
    for name, t in (("w", w), ("x", x), ("q", q)):
        if t.device != x.device or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"mod_matmul: {name} must be a contiguous "
                             f"int32 tensor on {x.device}")
    if w.dim() != 3 or x.dim() != 3 or w.shape[0] != x.shape[0] or \
            w.shape[2] != x.shape[1] or q.numel() != w.shape[0]:
        raise ValueError(f"mod_matmul: shapes w {tuple(w.shape)}, x "
                         f"{tuple(x.shape)}, q {tuple(q.shape)} disagree")
    k, d_dim, a_dim = w.shape
    if a_dim > MAX_DEPTH:
        raise ValueError(f"mod_matmul: depth {a_dim} above {MAX_DEPTH}")
    b_dim = x.shape[2]
    out = x.new_empty((k, d_dim, b_dim))
    _build.launch("modmatmul", "mod_matmul", w, x, q, out, k, d_dim, a_dim,
                  b_dim)
    return out


def _mod_matmul_ref(w: torch.Tensor, x: torch.Tensor,
                    q: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel l, exact on the CPU and on the card (where
    torch.matmul has no int64): x is cut into four 8-bit limbs, each limb
    product is a float64 bmm (every sum below 2^53), reduced in int64 and
    recombined with 2^(8l) mod q."""
    if w.shape[-1] > MAX_REF_DEPTH:
        raise ValueError(f"_mod_matmul_ref: depth {w.shape[-1]} above "
                         f"{MAX_REF_DEPTH}")
    qc = q.long().view(-1, 1, 1)
    wf = (w.long() & 0xFFFFFFFF).double()
    xl = x.long() & 0xFFFFFFFF
    acc = torch.zeros((w.shape[0], w.shape[1], x.shape[2]),
                      dtype=torch.int64, device=x.device)
    for l in range(LIMBS):
        limb = ((xl >> (LIMB_BITS * l)) & 0xFF).double()
        dot = torch.remainder(torch.bmm(wf, limb).long(), qc)
        scale = torch.remainder(
            torch.full_like(qc, 1 << (LIMB_BITS * l)), qc)
        acc = torch.remainder(acc + dot * scale, qc)
    return acc.int()
