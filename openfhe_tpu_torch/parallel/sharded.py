"""Limb-sharded mult + relinearize on portable building blocks, and the
CKKS rescale inside the sharded region.

Counterpart of `openfhe_tpu/parallel/sharded.py`: the same communication
pattern as `parallel/sharded_fused.py` (every per-tower op local to the
shard owning the tower, the two base conversions fed by `all_gather`s),
but built from the port's general operations instead of the fused
key-switch kernels: the NTTs are `ops.ntt` (kernels a and b on CUDA), the
conversions `ops.modmatmul.mod_matmul_rowmod` (kernel k), the tensor
product and the key products plain torch. It runs on the fused body's
tables and per-shard views (`sharded_fused.make_sharded_fused_tables`,
`shard_views`: the JAX package's two table sets differ only in the fused
one's int8 limb stacks, which the port does not have), and its words
equal the fused body's and the unsharded chain's.

`drop_last_and_scale_sharded` is the rescale inside the sharded region: a
depth chain does not leave it between levels. The dropped tower's row is
brought to COEFF by its owner and broadcast (the JAX package's masked
psum); every other row is local, and the dropped row comes back zeroed, so
the layout keeps its shape and the caller tracks the real tower count, as
a padded level's tables do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openfhe_tpu_torch.lattice.basis import Basis
from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.ops.modmatmul import mod_matmul_rowmod
from openfhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from openfhe_tpu_torch.parallel import (Mesh, all_gather, broadcast,
                                        run_groups)
from openfhe_tpu_torch.parallel import sharded_fused as sf
from openfhe_tpu_torch.pke.keyswitch import ks_fused


def mult_relin_local(a0, a1, b0, b1, views) -> tuple:
    """One limb group (lists of the shards' [kql_loc, N] EVAL blocks and
    their ShardTables) -> the lists of the two output elements' blocks."""
    c0, c1, c2, y = [], [], [], []
    for x0, x1, y0, y1, v in zip(a0, a1, b0, b1, views):
        bq = v.q.basis_ql
        q = bq.q
        c0.append(mo.mul_mod(x0, y0, q))
        c2.append(mo.mul_mod(x1, y1, q))
        cross = mo.mul_mod(mo.add_mod(x0, x1, q), mo.add_mod(y0, y1, q), q)
        c1.append(mo.sub_mod(mo.sub_mod(cross, c0[-1], q), c2[-1], q))
        y.append(mo.mul_mod_shoup(ntt_inv(c2[-1], bq), v.q.bhatinv_q,
                                  v.q.bhatinv_q_sh, q))
    # mixing point 1: every digit's coefficients, and c2 for the own rows
    y_all, c2_all = all_gather(y), all_gather(c2)
    ext = []
    for yy, cc2, v in zip(y_all, c2_all, views):
        y_pad = ks_fused._pad_digits(yy, v)
        b = v.basis_qlp
        bv, _, av, _ = v.keys
        e0 = e1 = None
        for j in range(v.nd):
            conv = mod_matmul_rowmod(y_pad[j], v.conv_w[j], v.conv_w_sh[j],
                                     b.q)
            s = sf.take_own(ntt_fwd(conv, b), cc2, v, j)
            t0, t1 = mo.mul_mod(s, bv[j], b.q), mo.mul_mod(s, av[j], b.q)
            e0 = t0 if e0 is None else mo.add_mod(e0, t0, b.q)
            e1 = t1 if e1 is None else mo.add_mod(e1, t1, b.q)
        ext.append(torch.stack([e0, e1]))
    # mixing point 2: ApproxModDown needs every P row
    outs0, outs1 = [], []
    for e, x0, x1, v in zip(all_gather(ext, 1), c0, c1, views):
        bq, bp = v.q.basis_ql, v.p.basis_p
        pc = mo.mul_mod_shoup(ntt_inv(e[:, v.kql:].contiguous(), bp),
                              v.p.pscale, v.p.pscale_sh, bp.q)
        s = ntt_fwd(mod_matmul_rowmod(pc, v.pconv_w, v.pconv_w_sh, bq.q), bq)
        d = mo.mul_mod_shoup(mo.sub_mod(e[:, v.q0:v.q0 + bq.k], s, bq.q),
                             v.q.pinv_q, v.q.pinv_q_sh, bq.q)
        outs0.append(mo.add_mod(x0, d[0], bq.q))
        outs1.append(mo.add_mod(x1, d[1], bq.q))
    return outs0, outs1


def mult_relin_sharded(a0, a1, b0, b1, st: sf.ShardedFusedTables,
                       mesh: Mesh, axis: str = "limb") -> tuple:
    """`sharded_fused.mult_relin_sharded` on the portable body."""
    views = sf.shard_views(st, mesh, axis)
    return run_groups(
        lambda pos, *args: mult_relin_local(*args, [views[p] for p in pos]),
        (a0, a1, b0, b1), mesh, axis)


# ---------------------------------------------------------------------------
# the rescale inside the sharded region
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedDropTables:
    """DropLastElementAndScale of tower size_ql - 1, laid out over kql =
    pad_to (or size_ql) rows: q_l^-1 mod q_i with its companion and
    floor(q_l / 2) mod q_i, zero on the dropped row and past it."""
    basis_ql: Basis           # [kql] the rows' towers
    basis_last: Basis         # [1] the dropped tower
    qlinv: torch.Tensor       # [kql, 1]
    qlinv_sh: torch.Tensor
    ql_half_modqi: torch.Tensor
    ql_half: int
    kql: int
    views: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)


def make_sharded_drop_tables(cc, size_ql: int, pad_to: int | None = None
                             ) -> ShardedDropTables:
    """Tables for dropping tower size_ql - 1 of the context's chain
    (`cc.basis_q`), rows padded to pad_to."""
    kb = pad_to or size_ql
    moduli = list(cc.basis_q.moduli[:size_ql])
    ql, rest = moduli[-1], moduli[:-1]
    half = ql >> 1
    qlinv = np.zeros((kb, 1), np.uint64)
    hmod = np.zeros((kb, 1), np.uint64)
    mods = np.ones((kb, 1), np.uint64)
    for i, q in enumerate(rest):
        qlinv[i, 0] = pow(ql % q, -1, q)
        hmod[i, 0] = half % q
        mods[i, 0] = q
    dev = cc.basis_q.device
    return ShardedDropTables(
        cc.basis_q.slice(0, kb), cc.basis_q.slice(size_ql - 1, size_ql),
        mo.u32_tensor(qlinv, dev),
        mo.u32_tensor((qlinv << np.uint64(32)) // mods, dev),
        mo.u32_tensor(hmod, dev), ql_half=half, kql=kb)


def _drop_view(dt: ShardedDropTables, limb: int, idx: int, device):
    """(basis, qlinv, qlinv_sh, hmod, basis_last) of shard idx on
    `device` (cached in dt.views)."""
    key = (limb, idx, str(device))
    if key not in dt.views:
        rows = dt.kql // limb
        lo = idx * rows
        cut = lambda t: t[lo:lo + rows].to(device).contiguous()
        dt.views[key] = (dt.basis_ql.slice(lo, lo + rows).to(device),
                         cut(dt.qlinv), cut(dt.qlinv_sh),
                         cut(dt.ql_half_modqi), dt.basis_last.to(device))
    return dt.views[key]


def drop_last_and_scale_local(x: torch.Tensor, u: torch.Tensor, view,
                              ql_half: int) -> torch.Tensor:
    """One shard's rescale: x [kql_loc, N] EVAL and u [1, N], the dropped
    tower's row in COEFF -> round(x / q_l) on the shard's rows, zero on
    the dropped row (the words of rns_tools.drop_last_and_scale)."""
    basis, qlinv, qlinv_sh, hmod, last = view
    q = basis.q
    u_shift = mo.add_mod(u, ql_half, last.q)
    w = mo.sub_mod(torch.remainder(u_shift.long(), q.long()).int(), hmod, q)
    diff = mo.sub_mod(x, ntt_fwd(w, basis), q)
    return mo.mul_mod_shoup(diff, qlinv, qlinv_sh, q)


def drop_last_and_scale_sharded(x: list, dt: ShardedDropTables,
                                drop_row: int, mesh: Mesh,
                                axis: str = "limb") -> list:
    """CKKS rescale of one sharded element (blocks [kql_loc, N] or
    [b, kql_loc, N], EVAL) dropping global row drop_row: its owner's INTT
    of that row is broadcast to the group, the rest is local. Returns the
    same layout with the dropped row zeroed."""
    views = [_drop_view(dt, mesh.shape[axis], c[axis], dev)
             for c, dev in zip(mesh.coords(), mesh.flat)]

    def body(pos, xs):
        owner, row = divmod(drop_row, xs[0].shape[-2])
        last = views[pos[owner]][4]
        u = ntt_inv(xs[owner][row:row + 1].contiguous(), last)
        return ([drop_last_and_scale_local(xx, uu, views[p], dt.ql_half)
                 for xx, uu, p in zip(xs, broadcast(u, xs), pos)],)
    return run_groups(body, (x,), mesh, axis)[0]
