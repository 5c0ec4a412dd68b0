"""Modular matmuls: the RNS base conversion (kernel k) and the per-tower
matrix product of the 4-step NTT (kernel l).

Counterpart of `openfhe_tpu/ops/modmatmul.py` (reference analogs
DCRTPolyImpl::ApproxSwitchCRTBasis and the transformnat-impl.h
butterflies):

    mod_matmul_rowmod: out[..., j, n] = sum_i y[..., i, n] * W[i, j] mod d_j
    mod_matmul:        out[t, d, b]   = sum_a W[t, d, a] * X[t, a, b] mod q_t

Words are canonical residues (int32 bit patterns); the row-modulus W comes
with Shoup companions. The JAX package's signed int8 limbs (`balanced_
limbs_host`) and f32-quotient recombination (`_recombine`) exist for the
TPU's matrix unit and have no counterpart here. On a CUDA tensor each
wrapper launches its kernel (`csrc/rowmod.cu`, `csrc/modmatmul.cu`) or
raises; on a CPU tensor it runs its plain version. Kernel k has two
entries: the lazy conversion `mod_matmul_rowmod` (`csrc/pconv_core.cuh`,
which K2, K45 and the sharded n and o run too) and its former form
`mod_matmul_rowmod_eager`. Kernel l has two: `mod_matmul` on the int8
tensor cores, which multiply W's and X's unsigned byte limbs into 16 exact
int32 limb-pair sums, recombined per output word with the per-tower
constants of `limb_consts`, and its former form `mod_matmul_simt` on the
CUDA cores. A former form is its kernel's yardstick on the card, which no
wrapper falls back to.
"""

from __future__ import annotations

import collections
import functools
import math

import numpy as np
import torch

from openfhe_tpu_torch import _build
from openfhe_tpu_torch.math.modops import mod_constants, u32_tensor

# mod_matmul's plain version sums 8-bit limbs of X times W in float64:
# every sum stays below 2^8 * 2^32 * A, exact (< 2^53) over REF_CHUNK terms
LIMB_BITS = 8
LIMBS = 4
REF_CHUNK = 1 << 13
# the tensor-core kernel's limb-pair sums, at most 255 * 255 * A, stay
# below 2^31 (exact in int32) to A = 2^15; so do the former form's 64-bit
# sums of W * (16-bit half of X)
MAX_DEPTH = 1 << 15
# the limb weights s = i + j of the 16 limb pairs (i, j)
LIMB_GROUPS = 2 * LIMBS - 1


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


@functools.lru_cache(maxsize=64)
def _limb_consts(moduli: tuple, device: str) -> torch.Tensor:
    """[k, 17] int32 per tower: 2^(8 s) mod q for s = 0..6, their Shoup
    companions floor(c 2^32 / q), then q's `Basis.red64` row (2^32 mod q,
    its companion, floor(2^32 / q))."""
    rows = []
    for q in moduli:
        pw = [pow(2, LIMB_BITS * s, q) for s in range(LIMB_GROUPS)]
        rows.append(pw + [(c << 32) // q for c in pw]
                    + list(mod_constants(q)))
    return u32_tensor(np.array(rows, np.uint64), device)


# (device, address, version, shape) of a moduli tensor -> (the tensor, its
# constants); the entry holds the tensor, so its address is not reused
# while the entry lives, and an in-place write bumps its version
_CONSTS_BY_Q: collections.OrderedDict = collections.OrderedDict()


def limb_consts(q: torch.Tensor) -> torch.Tensor:
    """`_limb_consts` of the moduli in q (on q's device), cached per moduli
    tuple; q's words are read on the host once per moduli tensor."""
    key = (str(q.device), q.data_ptr(), q._version, tuple(q.shape))
    hit = _CONSTS_BY_Q.get(key)
    if hit is None:
        moduli = tuple(int(v) & 0xFFFFFFFF for v in q.reshape(-1).tolist())
        hit = _CONSTS_BY_Q[key] = (q, _limb_consts(moduli, str(q.device)))
        if len(_CONSTS_BY_Q) > 64:
            _CONSTS_BY_Q.popitem(last=False)
    return hit[1]


def mod_matmul(w: torch.Tensor, x: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """Per-tower (W @ X) mod q: w [k, D, A] and x [k, A, B] int32 words
    below 2^31, q [k, 1] int32 moduli below 2^31, A <= 2^15 -> [k, D, B]
    int32 (kernel l). On the card one launch of the tensor-core kernel;
    it raises on what the kernel refuses."""
    if x.device.type == "cpu":
        return _mod_matmul_ref(w, x, q)
    if x.device.type != "cuda":
        raise ValueError(f"mod_matmul: no kernel for device {x.device}")
    return _mod_matmul_cu(w, x, q, "mod_matmul")


def mod_matmul_simt(w: torch.Tensor, x: torch.Tensor,
                    q: torch.Tensor) -> torch.Tensor:
    """Kernel l's former form (CUDA cores, two 64-bit sums an output);
    CUDA tensors only."""
    if x.device.type != "cuda":
        raise ValueError(f"mod_matmul_simt: no kernel for device "
                         f"{x.device}")
    return _mod_matmul_cu(w, x, q, "mod_matmul_simt")


def _mod_matmul_cu(w, x, q, entry: str) -> torch.Tensor:
    """Check the operands, allocate out and launch `entry` (the constants
    go to the tensor-core kernel only); the entry checks its own limits."""
    for name, t in (("w", w), ("x", x), ("q", q)):
        if t.device != x.device or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"{entry}: {name} must be a contiguous "
                             f"int32 tensor on {x.device}")
    if w.dim() != 3 or x.dim() != 3 or w.shape[0] != x.shape[0] or \
            w.shape[2] != x.shape[1] or q.numel() != w.shape[0]:
        raise ValueError(f"{entry}: shapes w {tuple(w.shape)}, x "
                         f"{tuple(x.shape)}, q {tuple(q.shape)} disagree")
    k, d_dim, a_dim = w.shape
    if a_dim > MAX_DEPTH:
        raise ValueError(f"{entry}: depth {a_dim} above {MAX_DEPTH}")
    b_dim = x.shape[2]
    out = x.new_empty((k, d_dim, b_dim))
    consts = (limb_consts(q),) if entry == "mod_matmul" else ()
    _build.launch("modmatmul", entry, w, x, q, *consts, out, k, d_dim, a_dim,
                  b_dim)
    return out


def _mod_matmul_ref(w: torch.Tensor, x: torch.Tensor,
                    q: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel l, exact on the CPU and on the card (where
    torch.matmul has no int64) for any depth: x is cut into four 8-bit
    limbs and A into chunks of REF_CHUNK terms; each limb product of a
    chunk is a float64 bmm (every sum below 2^53), reduced in int64 and
    recombined with 2^(8l) mod q."""
    qc = q.long().view(-1, 1, 1)
    wl = w.long() & 0xFFFFFFFF
    xl = x.long() & 0xFFFFFFFF
    acc = torch.zeros((w.shape[0], w.shape[1], x.shape[2]),
                      dtype=torch.int64, device=x.device)
    for a0 in range(0, w.shape[-1], REF_CHUNK):
        wf = wl[:, :, a0:a0 + REF_CHUNK].double()
        for l in range(LIMBS):
            limb = ((xl[:, a0:a0 + REF_CHUNK] >> (LIMB_BITS * l))
                    & 0xFF).double()
            dot = torch.remainder(torch.bmm(wf, limb).long(), qc)
            scale = torch.remainder(
                torch.full_like(qc, 1 << (LIMB_BITS * l)), qc)
            acc = torch.remainder(acc + dot * scale, qc)
    return acc.int()
