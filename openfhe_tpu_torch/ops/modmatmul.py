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
its plain version. Kernel k has two entries: the lazy conversion
`mod_matmul_rowmod` (`csrc/pconv_core.cuh`, which K2, K45 and the sharded
n run too) and its former form `mod_matmul_rowmod_eager`, its yardstick
on the card, which no wrapper falls back to.
"""

from __future__ import annotations

import math

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
                      d: torch.Tensor, red: torch.Tensor) -> torch.Tensor:
    """y [..., A, N] int32 words, w / w_sh [A, D] int32 (w canonical mod
    d_j, with Shoup companions), d [D, 1] int32 moduli below 2^31, red
    [D, 3] their `Basis.red64` -> [..., D, N] int32, canonical.

    On the card one launch of the lazy conversion (`pconv`); a launch
    it refuses (more than 64 input rows, tables above 48 KB of shared
    memory, N not a multiple of 4, y or out off a 16-byte boundary)
    raises."""
    if y.device.type == "cpu":
        return _mod_matmul_rowmod_ref(y, w, d)
    if y.device.type != "cuda":
        raise ValueError(f"mod_matmul_rowmod: no kernel for device "
                         f"{y.device}")
    return _mod_matmul_rowmod_cu(y, w, w_sh, d, red, "mod_matmul_rowmod")


def mod_matmul_rowmod_eager(y: torch.Tensor, w: torch.Tensor,
                            w_sh: torch.Tensor,
                            d: torch.Tensor) -> torch.Tensor:
    """Kernel k's former form (every term reduced at once, one thread a
    column) at any shape it takes; CUDA tensors only."""
    if y.device.type != "cuda":
        raise ValueError("mod_matmul_rowmod_eager: no kernel for device "
                         f"{y.device}")
    return _mod_matmul_rowmod_cu(y, w, w_sh, d, None,
                                 "mod_matmul_rowmod_eager")


def _mod_matmul_rowmod_cu(y, w, w_sh, d, red, entry) -> torch.Tensor:
    """Check the operands, allocate out and launch `entry` (red is passed
    to the lazy form only); the entry checks its own limits."""
    operands = (("y", y), ("w", w), ("w_sh", w_sh), ("d", d), ("red", red))
    for arg, t in operands:
        if t is not None and (t.device != y.device or t.dtype != torch.int32
                              or not t.is_contiguous()):
            raise ValueError(f"{entry}: {arg} must be a contiguous int32 "
                             f"tensor on {y.device}")
    a_dim, d_dim = w.shape
    if y.dim() < 2 or y.shape[-2] != a_dim or w_sh.shape != w.shape or \
            d.numel() != d_dim or \
            (red is not None and tuple(red.shape) != (d_dim, 3)):
        raise ValueError(f"{entry}: shapes y {tuple(y.shape)}, w "
                         f"{tuple(w.shape)}, d {tuple(d.shape)} disagree")
    n = y.shape[-1]
    out = y.new_empty(tuple(y.shape[:-2]) + (d_dim, n))
    batch = math.prod(y.shape[:-2])
    args = (red,) if entry == "mod_matmul_rowmod" else ()
    _build.launch("rowmod", entry, y, w, w_sh, d, *args, out, batch, a_dim,
                  d_dim, n)
    return out


def _mod_matmul_rowmod_ref(y: torch.Tensor, w: torch.Tensor,
                           d: torch.Tensor) -> torch.Tensor:
    """Plain int64 version of the kernels: one reduced product per input
    row, the words of y read as unsigned 32-bit integers, as the kernels
    read them (each product < 2^63 - 2^32, the running sum below 2^63)."""
    q = d.long().view(-1, 1)                          # [D, 1]
    wl = w.long()
    yl = y.long() & 0xFFFFFFFF
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
