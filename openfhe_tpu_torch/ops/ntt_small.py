"""Small-ring negacyclic NTT (128 <= N <= 2048, k <= 4 towers): kernel m.

Counterpart of `openfhe_tpu/ops/ntt_small.py`, whose TPU kernel computes
each transform as one dense [B, N] x [N, N] product of int8 limbs on the
MXU. The function is the same as `ops/ntt.py`'s: COEFF natural order ->
EVAL bit-reversed order and back, N^-1 included, with the basis' own
roots, so the words equal the JAX package's.

`ntt_small_fwd` / `ntt_small_inv` take `[..., k, N]` int32 residues and a
`Basis`. On a CUDA tensor they launch the butterfly kernel of
`csrc/ntt_small.cu` (or raise): a row a group of N / 16 threads with 16
words each in registers, several groups a block, a block a tower, its
grid from `launch_geometry`. On a CPU tensor they run the plain versions
`_ntt_small_fwd_ref` / `_ntt_small_inv_ref`, which follow the TPU
kernel's own formulation, the dense matrices of `_tables_from_psi`:

    fwd[j, i] = psi^(i * e_j),  inv[i, j] = N^-1 * psi^(-i * e_j),
    e_j = 2 * brv(j) + 1,

computed exactly: x is split into four 8-bit limbs, each limb times the
full-residue matrix in float64 (every sum stays below 2^8 * 2^31 * 2^11 =
2^50 < 2^53), reduced in int64 and recombined with 2^(8l) mod q. They
share no code with the kernel, so the card's comparison tests something.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openfhe_tpu_torch import _build
from openfhe_tpu_torch.lattice.basis import Basis, _bitrev_indices
from openfhe_tpu_torch.math.modops import to_u32

MIN_RING_DIM = 128
MAX_RING_DIM = 1 << 11
MAX_TOWERS = 4
LIMB_BITS = 8
LIMBS = 4
# The kernel's launch geometry (`csrc/ntt_small.cu`: kLogR of
# `ntt_cluster.cuh`, kBlockThreads, kBlocksPerSm); the tests hold the two
# equal.
LOG_THREAD_WORDS = 4
BLOCK_THREADS = 128
BLOCKS_PER_SM = 4


def launch_geometry(polys: int, k: int, n: int, sms: int) -> tuple:
    """(blocks a tower, groups a block) of the kernel over `polys` rows of
    each of k towers at ring N on a card of `sms` SMs, as its launch
    computes them: a group of N / 16 threads a row; as many groups as the
    card holds at once (BLOCKS_PER_SM blocks of BLOCK_THREADS threads an
    SM), each with the same share of its tower's rows, taken one after
    another; at most BLOCK_THREADS threads a block. Group g of block b of
    tower t takes the rows p * k + t, p = b * groups + g + i * blocks *
    groups < polys."""
    per_block = BLOCK_THREADS // (n >> LOG_THREAD_WORDS)
    slots = sms * BLOCKS_PER_SM * per_block
    per_group = -(-polys * k // slots)
    groups = -(-polys // per_group)
    gpb = min(per_block, groups)
    return -(-groups // gpb), gpb


def supported(b: Basis) -> bool:
    """Whether the small-ring kernel takes rings of this basis."""
    n = b.ring_dim
    return (MIN_RING_DIM <= n <= MAX_RING_DIM and n & (n - 1) == 0
            and b.k <= MAX_TOWERS)


def ntt_small_fwd(x: torch.Tensor, b: Basis) -> torch.Tensor:
    """Negacyclic forward NTT: COEFF (natural order) -> EVAL (bit-reversed)."""
    if x.device.type == "cpu":
        return _ntt_small_fwd_ref(x, b)
    out, rows, log_n = _prepare(x, b, "ntt_small_fwd")
    _build.launch("ntt_small", "ntt_small_fwd", x, out, b.psi_br,
                  b.psi_br_sh, b.q, rows, b.k, log_n)
    return out


def ntt_small_inv(x: torch.Tensor, b: Basis) -> torch.Tensor:
    """Negacyclic inverse NTT: EVAL (bit-reversed) -> COEFF (natural)."""
    if x.device.type == "cpu":
        return _ntt_small_inv_ref(x, b)
    out, rows, log_n = _prepare(x, b, "ntt_small_inv")
    _build.launch("ntt_small", "ntt_small_inv", x, out, b.ipsi_br,
                  b.ipsi_br_sh, b.q, b.ninv, b.ninv_sh, rows, b.k, log_n)
    return out


def _prepare(x: torch.Tensor, b: Basis, name: str):
    """Check a kernel call's operands; allocate its output."""
    n = b.ring_dim
    if not supported(b):
        raise ValueError(f"{name}: takes 128 <= N <= 2048 (a power of 2) "
                         f"and k <= {MAX_TOWERS} towers, not N={n}, "
                         f"k={b.k}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 residues, got {x.dtype}")
    if x.dim() < 2 or x.shape[-2] != b.k or x.shape[-1] != n:
        raise ValueError(f"{name}: shape {tuple(x.shape)} does not match "
                         f"[..., {b.k}, {n}]")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if b.device != x.device:
        raise ValueError(f"{name}: tensor on {x.device}, basis on "
                         f"{b.device}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: input must be 16-byte aligned")
    return torch.empty_like(x), x.numel() // n, n.bit_length() - 1


@functools.lru_cache(maxsize=None)
def _dense_tables(n: int, moduli: tuple, psis: tuple) -> tuple:
    """Host float64 matrices [k, N, N] (output index, input index) of the
    forward and inverse transforms, and the limb weights [k, LIMBS]
    2^(8l) mod q, for the 2N-th roots `psis`."""
    rev = _bitrev_indices(n)
    e = (2 * rev.astype(np.int64) + 1) % (2 * n)
    idx = np.arange(n, dtype=np.int64)
    fwd, inv = [], []
    for q, psi in zip(moduli, psis):
        pows = np.ones(2 * n, np.int64)
        for i in range(1, 2 * n):
            pows[i] = pows[i - 1] * psi % q
        ninv = pow(n, -1, q)
        fwd.append(pows[(e[:, None] * idx[None, :]) % (2 * n)])
        inv.append(pows[(-(idx[:, None] * e[None, :])) % (2 * n)]
                   * ninv % q)
    limb_w = np.array([[pow(2, LIMB_BITS * l, q) for l in range(LIMBS)]
                       for q in moduli], np.int64)
    return (np.stack(fwd).astype(np.float64),
            np.stack(inv).astype(np.float64), limb_w)


@functools.lru_cache(maxsize=8)
def _device_tables(n: int, moduli: tuple, psis: tuple, which: int,
                   device: str):
    tabs = _dense_tables(n, moduli, psis)
    return (torch.from_numpy(tabs[which]).to(device),
            torch.from_numpy(tabs[2]).to(device))


def _dense_apply(x: torch.Tensor, b: Basis, which: int) -> torch.Tensor:
    """out[..., t, j] = sum_i W_t[j, i] * x[..., t, i] mod q_t, exact."""
    n = b.ring_dim
    # psi_br holds psi^brv(j): bit-reversed index 1 holds psi itself
    rev1 = int(_bitrev_indices(n)[1])
    psis = tuple(int(v) for v in to_u32(b.psi_br[:, rev1]))
    w, limb_w = _device_tables(n, b.moduli, psis, which, str(x.device))
    q = b.q.long()                                   # [k, 1]
    xs = x.reshape(-1, b.k, n).long().transpose(0, 1)  # [k, rows, N]
    acc = torch.zeros(xs.shape, dtype=torch.int64, device=x.device)
    for l in range(LIMBS):
        limb = ((xs >> (LIMB_BITS * l)) & 0xFF).double()
        dot = torch.bmm(limb, w.transpose(1, 2)).long()   # < 2^50, exact
        term = torch.remainder(torch.remainder(dot, q[:, :, None])
                               * limb_w[:, l, None, None], q[:, :, None])
        acc = torch.remainder(acc + term, q[:, :, None])
    return acc.transpose(0, 1).reshape(x.shape).int()


def _ntt_small_fwd_ref(x: torch.Tensor, b: Basis) -> torch.Tensor:
    """Plain version of the forward kernel: the dense forward matrix."""
    return _dense_apply(x, b, 0)


def _ntt_small_inv_ref(x: torch.Tensor, b: Basis) -> torch.Tensor:
    """Plain version of the inverse kernel: the dense inverse matrix."""
    return _dense_apply(x, b, 1)
