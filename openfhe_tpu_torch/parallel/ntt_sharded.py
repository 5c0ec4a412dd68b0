"""The staged 4-step NTT with its columns sharded over a mesh axis.

Counterpart of `openfhe_tpu/parallel/ntt_sharded.py`: the Bailey 4-step
transform of `ops/ntt4step.py` distributed as distributed FFTs are. Each
matrix stage is local to a shard (kernel l, `ops.modmatmul.mod_matmul`),
and the stage boundary is an `all_to_all` transpose:

    X [k, R, C]   sharded over C (columns)
      stage 1:  S1 = WR @ X        contracts over R: column-local
      twiddle:  S1 * TW            elementwise, the shard's TW columns
      all_to_all: C-sharded -> R-sharded (the distributed transpose)
      stage 2:  Y^T = WC @ S2^T    contracts over C: row-local
      all_to_all: back to C-sharded, so input and output layouts match

The inverse runs the same steps backwards. The bit-reversals are folded
into the tables, so the words equal `ops.ntt.ntt_fwd` / `ntt_inv` on any
mesh axis whose size divides R and C. One transform with L shards makes
2L launches of kernel l.
"""

from __future__ import annotations

import functools

import torch

from openfhe_tpu_torch.lattice.basis import Basis
from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.ops.modmatmul import mod_matmul
from openfhe_tpu_torch.ops import ntt4step
from openfhe_tpu_torch.parallel import Mesh, all_to_all


@functools.lru_cache(maxsize=64)
def _shard_tables(moduli: tuple, n: int, dev: str, idx: int,
                  shards: int) -> dict:
    """The 4-step tables on `dev`, with the twiddles cut to shard idx's
    columns (cached, as dev_tables is)."""
    t = ntt4step.dev_tables(moduli, n, dev)
    cols = t["tw"].shape[-1] // shards
    cut = lambda x: x[:, :, idx * cols:(idx + 1) * cols].contiguous()
    return dict(t, **{k: cut(t[k]) for k in ("tw", "tw_sh", "twi",
                                              "twi_sh")})


def _twiddle(x, tw, tw_sh, q):
    return mo.mul_mod_shoup(x, tw, tw_sh, q.view(-1, 1, 1))


def _fwd(parts: list, tabs: list) -> list:
    """Per-shard blocks [k, R, Cloc] -> the same layout, transformed."""
    s2 = [_twiddle(mod_matmul(t["wr"], x, t["q"]), t["tw"], t["tw_sh"],
                   t["q"]) for x, t in zip(parts, tabs)]
    s2 = all_to_all(s2, 1, 2)                               # [k, Rloc, C]
    y = [mod_matmul(t["wc"], s.transpose(1, 2).contiguous(),
                    t["q"]).transpose(1, 2) for s, t in zip(s2, tabs)]
    return all_to_all(y, 2, 1)                              # [k, R, Cloc]


def _inv(parts: list, tabs: list) -> list:
    y = all_to_all(parts, 1, 2)                             # [k, Rloc, C]
    s2 = [mod_matmul(t["wci"], x.transpose(1, 2).contiguous(),
                     t["q"]).transpose(1, 2) for x, t in zip(y, tabs)]
    s2 = all_to_all(s2, 2, 1)                               # [k, R, Cloc]
    return [mod_matmul(t["wri"], _twiddle(s, t["twi"], t["twi_sh"], t["q"]),
                       t["q"]) for s, t in zip(s2, tabs)]


def _apply(x: torch.Tensor, b: Basis, mesh: Mesh, axis: str,
           inverse: bool) -> torch.Tensor:
    r, c = ntt4step.split(b.ring_dim)
    group = mesh.groups(axis)[0]
    devs = [mesh.flat[p] for p in group]
    d = len(devs)
    if r % d or c % d:
        raise ValueError(f"mesh axis size {d} must divide R={r} and C={c}")
    if x.dim() != 2 or x.shape[0] != b.k:
        raise ValueError("sharded NTT takes one [k, N] element at a time")
    k, cloc = b.k, c // d
    xx = x.reshape(k, r, c)
    parts = [xx[:, :, i * cloc:(i + 1) * cloc].to(dev).contiguous()
             for i, dev in enumerate(devs)]
    tabs = [_shard_tables(tuple(b.moduli), b.ring_dim, str(dev), i, d)
            for i, dev in enumerate(devs)]
    out = (_inv if inverse else _fwd)(parts, tabs)
    return torch.cat([p.to(x.device) for p in out], 2).reshape(k, r * c)


def ntt_fwd_sharded(x: torch.Tensor, b: Basis, mesh: Mesh,
                    axis: str = "limb") -> torch.Tensor:
    """COEFF -> EVAL (bit-reversed) with the columns sharded over the
    first group of `axis`; the words of ops.ntt.ntt_fwd. x: [k, N] int32,
    returned on x's device."""
    return _apply(x, b, mesh, axis, inverse=False)


def ntt_inv_sharded(y: torch.Tensor, b: Basis, mesh: Mesh,
                    axis: str = "limb") -> torch.Tensor:
    """EVAL (bit-reversed) -> COEFF, sharded as ntt_fwd_sharded."""
    return _apply(y, b, mesh, axis, inverse=True)
