"""Batched negacyclic NTT over RNS towers: kernels 1 and 2 of the port.

Counterpart of `openfhe_tpu/ops/ntt.py` + `ops/ntt_fused.py` (reference:
`ForwardTransformToBitReverse` / `InverseTransformFromBitReverse`,
transformnat-impl.h). Cooley-Tukey DIT forward and Gentleman-Sande
inverse with twiddles in bit-reversed order; EVAL form is bit-reversed,
with the JAX package's roots, so the words are the JAX package's.

`ntt_fwd` / `ntt_inv` take `[..., k, N]` int32 residues and a `Basis`.
On a CUDA tensor they launch a hand-written kernel (or raise), as the JAX
package's `ops/ntt.py` dispatches: rings with 128 <= N <= 2048 and k <= 4
towers (BinFHE's) go to `ops/ntt_small.py` (`csrc/ntt_small.cu`), every
other ring to `csrc/ntt.cu`. There the ring alone picks the transform:
for 2^4 <= N <= 2^17 one launch of the cluster transform (a tower per
thread-block cluster of `cluster_geometry(N)`), otherwise the staged
transform (one launch per device-memory stage, then a tile pass). On a
CPU tensor they run the plain int64 stage loop `_ntt_fwd_ref` /
`_ntt_inv_ref`, which the tests hold against JAX at every N.
"""

from __future__ import annotations

import torch

from openfhe_tpu_torch import _build
from openfhe_tpu_torch.lattice.basis import Basis
from openfhe_tpu_torch.ops import ntt_small


def ntt_fwd(x: torch.Tensor, b: Basis) -> torch.Tensor:
    """Negacyclic forward NTT: COEFF (natural order) -> EVAL (bit-reversed)."""
    if x.device.type == "cpu":
        return _ntt_fwd_ref(x, b)
    if ntt_small.supported(b):
        return ntt_small.ntt_small_fwd(x, b)
    return _ntt_fwd_cu(x, b)


def ntt_inv(x: torch.Tensor, b: Basis) -> torch.Tensor:
    """Negacyclic inverse NTT: EVAL (bit-reversed) -> COEFF (natural)."""
    if x.device.type == "cpu":
        return _ntt_inv_ref(x, b)
    if ntt_small.supported(b):
        return ntt_small.ntt_small_inv(x, b)
    return _ntt_inv_cu(x, b)


# The cluster transform's geometry (`csrc/ntt_cluster.cuh`): a tower of N
# words takes a cluster of N / W blocks of W = min(N, max(2^13, N / 8))
# words (at most 8 blocks, the portable cluster size), each thread holding
# 2^4 words; the kernel takes 2^4 <= N <= 2^17. The header's constants
# (kClusterLogW, kLogR, kMaxLogC, kMaxClusterLogN) are these; the tests
# hold the two to each other.
CLUSTER_LOG_WORDS = 13
CLUSTER_LOG_THREAD_WORDS = 4
CLUSTER_MAX_LOG_CTAS = 3
CLUSTER_MAX_LOG_N = 17


def cluster_geometry(n: int):
    """(ctas, words_per_cta, smem_bytes) of the cluster transform of a
    ring of N words: each tower a cluster of `ctas` blocks of
    `words_per_cta` words (and as many 4-byte words of shared memory,
    `smem_bytes`). None for the rings it does not take, which the staged
    transform serves."""
    log_n = n.bit_length() - 1
    if n != 1 << log_n or not (CLUSTER_LOG_THREAD_WORDS <= log_n
                               <= CLUSTER_MAX_LOG_N):
        return None
    log_w = min(log_n, max(CLUSTER_LOG_WORDS, log_n - CLUSTER_MAX_LOG_CTAS))
    return n >> log_w, 1 << log_w, 4 << log_w


def _ntt_fwd_cu(x: torch.Tensor, b: Basis) -> torch.Tensor:
    """The forward transform of `csrc/ntt.cu`, any N: one launch of the
    cluster transform where `cluster_geometry` takes the ring, else the
    staged transform."""
    if cluster_geometry(b.ring_dim) is None:
        return _ntt_fwd_staged_cu(x, b)
    return _ntt_fwd_launch(x, b, "ntt_fwd")


def _ntt_inv_cu(x: torch.Tensor, b: Basis) -> torch.Tensor:
    """The inverse transform of `csrc/ntt.cu`, any N; as `_ntt_fwd_cu`."""
    if cluster_geometry(b.ring_dim) is None:
        return _ntt_inv_staged_cu(x, b)
    return _ntt_inv_launch(x, b, "ntt_inv")


def _ntt_fwd_staged_cu(x: torch.Tensor, b: Basis) -> torch.Tensor:
    """The staged forward transform of `csrc/ntt.cu`, any N."""
    return _ntt_fwd_launch(x, b, "ntt_fwd_staged")


def _ntt_inv_staged_cu(x: torch.Tensor, b: Basis) -> torch.Tensor:
    """The staged inverse transform of `csrc/ntt.cu`, any N."""
    return _ntt_inv_launch(x, b, "ntt_inv_staged")


def _ntt_fwd_launch(x: torch.Tensor, b: Basis, entry: str) -> torch.Tensor:
    out, rows, log_n = _prepare(x, b, entry)
    _build.launch("ntt", entry, x, out, b.psi_br, b.psi_br_sh, b.q, rows,
                  b.k, log_n)
    return out


def _ntt_inv_launch(x: torch.Tensor, b: Basis, entry: str) -> torch.Tensor:
    out, rows, log_n = _prepare(x, b, entry)
    _build.launch("ntt", entry, x, out, b.ipsi_br, b.ipsi_br_sh, b.q,
                  b.ninv, b.ninv_sh, rows, b.k, log_n)
    return out


def _prepare(x: torch.Tensor, b: Basis, name: str):
    """Check a kernel call's operands; allocate its output."""
    n = b.ring_dim
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if b.device != x.device:
        raise ValueError(f"{name}: tensor on {x.device}, basis on "
                         f"{b.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 residues, got {x.dtype}")
    if x.dim() < 2 or x.shape[-2] != b.k or x.shape[-1] != n:
        raise ValueError(f"{name}: shape {tuple(x.shape)} does not match "
                         f"[..., {b.k}, {n}]")
    if n < 2 or n & (n - 1):
        raise ValueError(f"{name}: ring dimension {n} is not a power of 2")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    return torch.empty_like(x), x.numel() // n, n.bit_length() - 1


def _ntt_fwd_ref(x: torch.Tensor, b: Basis) -> torch.Tensor:
    """Plain int64 version of the forward kernel (`_ntt_fwd_vpu`)."""
    n = b.ring_dim
    lead = tuple(x.shape[:-1])
    q = b.q.long().view(b.k, 1, 1)
    psi = b.psi_br.long()
    y = x.long()
    m, t = 1, n
    while m < n:
        t //= 2
        ys = y.reshape(lead + (m, 2, t))
        u = ys[..., 0, :]
        v = torch.remainder(ys[..., 1, :] * psi[:, m:2 * m, None], q)
        s = u + v
        d = u - v
        y = torch.stack([torch.where(s >= q, s - q, s),
                         torch.where(d < 0, d + q, d)],
                        dim=-2).reshape(lead + (n,))
        m *= 2
    return y.int()


def _ntt_inv_ref(x: torch.Tensor, b: Basis) -> torch.Tensor:
    """Plain int64 version of the inverse kernel (`_ntt_inv_vpu`)."""
    n = b.ring_dim
    lead = tuple(x.shape[:-1])
    q = b.q.long().view(b.k, 1, 1)
    ipsi = b.ipsi_br.long()
    y = x.long()
    m, t = n // 2, 1
    while m >= 1:
        ys = y.reshape(lead + (m, 2, t))
        u = ys[..., 0, :]
        v = ys[..., 1, :]
        s = u + v
        d = u - v
        lo = torch.where(s >= q, s - q, s)
        hi = torch.remainder(torch.where(d < 0, d + q, d)
                             * ipsi[:, m:2 * m, None], q)
        y = torch.stack([lo, hi], dim=-2).reshape(lead + (n,))
        m //= 2
        t *= 2
    return torch.remainder(y * b.ninv.long(), b.q.long()).int()
