"""Row-modulus modular matmul, the RNS base conversion: kernel 3 of the port.

Counterpart of the row-modulus half of `openfhe_tpu/ops/modmatmul.py`
(`mod_matmul_rowmod`, reference analog
DCRTPolyImpl::ApproxSwitchCRTBasis):

    out[..., j, n] = sum_i y[..., i, n] * W[i, j]  mod d_j

W holds canonical residues [A, D] with Shoup companions (int32 bit
patterns); the JAX package's int8 limb form exists for the TPU's matrix
unit and has no counterpart here. On a CUDA tensor the wrapper launches
the kernel of `csrc/rowmod.cu` (or raises); on a CPU tensor it runs the
plain int64 loop `_mod_matmul_rowmod_ref`.
"""

from __future__ import annotations

import torch

from openfhe_tpu_torch import _build


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
    rc = _build.entry("rowmod", "mod_matmul_rowmod")(
        y.data_ptr(), w.data_ptr(), w_sh.data_ptr(), d.data_ptr(),
        out.data_ptr(), batch, a_dim, d_dim, n,
        torch.cuda.current_stream(y.device).cuda_stream)
    _build.record_launch(rc, "mod_matmul_rowmod")
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
