"""Limb-sharded mult + relinearize on the port's key-switch kernels.

Counterpart of `openfhe_tpu/parallel/sharded_fused.py`. The RNS towers of
one ciphertext pair are cut over the mesh's "limb" axis; every per-tower
kernel runs on a shard's own rows, and the two base-conversion mixing
points are `all_gather`s:

  K1t  tensor_intt           the shard's Q rows         (ks_fused kernel)
       -- all_gather y, c2 --
  n    conv_digits_rows      the shard's Q_l*P rows x every digit
  p    ntt_keymul_acc_rows   the shard's Q_l*P rows, own rows by global row
       -- all_gather ext --
  K4   intt_scale (p_rows)   all P rows on every shard (kp rarely divides)
  o    conv_p_to_q_rows      the shard's Q rows
  K6f  ntt_submul_final      the shard's Q rows, ext's read in place
                             (ks_fused kernel, ext_off)

One EvalMult over L shards is 6L launches: each of the six kernels once
per shard. Rows n, o and p are this module's wrappers (kernels of
`csrc/sharded.cu`, each with its plain twin for CPU tensors); K1t, K4 and
K6f are `pke/keyswitch/ks_fused.py`'s on per-shard table views.

Tables (`ShardedFusedTables`) are the fused chain's canonical residues
with Shoup companions at one level (no int8 limb stacks), optionally
padded to `pad_to` Q rows with zero weights: the JAX package's answer to a
level whose tower count stops dividing the limb axis. A padded level keeps
the chain's words on its real rows and zero on the pad rows. Each shard
takes views of them (`shard_views`: its rows of every sharded table and of
the eval key, on its device), the role of the JAX package's `table_specs`.
"""

from __future__ import annotations

import dataclasses

import torch

from openfhe_tpu_torch import _build
from openfhe_tpu_torch.lattice.basis import Basis
from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.ops.modmatmul import _mod_matmul_rowmod_ref
from openfhe_tpu_torch.ops.ntt import _ntt_fwd_ref
from openfhe_tpu_torch.parallel import Mesh, all_gather, run_groups
from openfhe_tpu_torch.pke.keys import EvalKey
from openfhe_tpu_torch.pke.keyswitch import hybrid, ks_fused
from openfhe_tpu_torch.pke.keyswitch.ks_fused import FusedKSTables


@dataclasses.dataclass(frozen=True)
class ShardedFusedTables:
    """One level's tables for limb sharding, whole (shards take views).

    `fused` is the fused chain's table set over kql = pad_to Q rows (zero
    weights and constants past the level's kql_real towers) and, when
    padded, every digit of the chain; `key` the eval key with companions,
    whole."""
    fused: FusedKSTables
    key: EvalKey
    kql_real: int
    views: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    @property
    def kql(self) -> int:
        return self.fused.kql

    @property
    def kp(self) -> int:
        return self.fused.kp


@dataclasses.dataclass(frozen=True)
class ShardTables:
    """One shard's views of a ShardedFusedTables, on the shard's device."""
    q: FusedKSTables         # the shard's Q rows: K1t, K6f (kp = 0)
    p: FusedKSTables         # the P rows of the gathered ext: K4
    basis_qlp: Basis         # the shard's Q_l*P rows: p's NTT, n's moduli
    conv_w: torch.Tensor     # [nd, alpha, kqlp_loc] digit weights (n)
    conv_w_sh: torch.Tensor
    pconv_w: torch.Tensor    # [kp, kql_loc] P -> Q weights (o)
    pconv_w_sh: torch.Tensor
    keys: tuple              # (bv, bv_sh, av, av_sh) [nd, kqlp_loc, N]
    q0: int                  # global Q row of the shard's first Q row
    tau0: int                # global Q_l*P row of its first Q_l*P row
    kql: int                 # the level's Q rows (padded)
    kql_real: int            # the level's real Q towers
    nd: int
    alpha: int


def _pad(t: torch.Tensor, dim: int, at: int, count: int) -> torch.Tensor:
    """`count` zero slices inserted into t along dim before index `at`."""
    if not count:
        return t
    shape = list(t.shape)
    shape[dim] = count
    return torch.cat([t.narrow(dim, 0, at), t.new_zeros(shape),
                      t.narrow(dim, at, t.shape[dim] - at)], dim)


def make_sharded_fused_tables_basis(basis_q: Basis, basis_p: Basis,
                                    size_ql: int, num_parts: int,
                                    key: EvalKey, pad_to: int | None = None
                                    ) -> ShardedFusedTables:
    """Tables of the level with size_ql Q towers of the chain basis_q
    (all k_q_full towers) and P = basis_p, padded to pad_to Q rows."""
    hybrid.require_companions(key)
    kb = pad_to or size_ql
    if not size_ql <= kb <= basis_q.k:
        raise ValueError(f"pad_to {kb} outside [{size_ql}, {basis_q.k}]")
    real = ks_fused.make_fused_ks_tables(
        basis_q.slice(0, size_ql).concat(basis_p), size_ql, basis_q.k,
        num_parts)
    pad = kb - size_ql
    nd = num_parts if pad else real.nd
    rows = lambda t: _pad(t, 0, size_ql, pad)
    conv = lambda w: _pad(_pad(w, 2, size_ql, pad), 0, real.nd, nd - real.nd)
    fused = dataclasses.replace(
        real, basis_qlp=basis_q.slice(0, kb).concat(basis_p),
        basis_ql=basis_q.slice(0, kb),
        bhatinv_q=rows(real.bhatinv_q), bhatinv_q_sh=rows(real.bhatinv_q_sh),
        k1_scale=rows(real.k1_scale), k1_scale_sh=rows(real.k1_scale_sh),
        conv_w=conv(real.conv_w), conv_w_sh=conv(real.conv_w_sh),
        pconv_w=_pad(real.pconv_w, 1, size_ql, pad),
        pconv_w_sh=_pad(real.pconv_w_sh, 1, size_ql, pad),
        t_modq=rows(real.t_modq), t_modq_sh=rows(real.t_modq_sh),
        pinv_q=rows(real.pinv_q), pinv_q_sh=rows(real.pinv_q_sh),
        kql=kb, nd=nd)
    return ShardedFusedTables(fused=fused, key=key, kql_real=size_ql)


def make_sharded_fused_tables(cc, size_ql: int, pad_to: int | None = None
                              ) -> ShardedFusedTables:
    """The tables of a context's level with size_ql Q towers and its
    (first) eval mult key."""
    key = next(iter(cc.eval_mult_keys.values()))
    return make_sharded_fused_tables_basis(
        cc.basis_q, cc.basis_p, size_ql, cc.params.num_large_digits, key,
        pad_to)


def require_divisible(st: ShardedFusedTables, limb: int) -> None:
    if st.kql % limb or (st.kql + st.kp) % limb:
        raise ValueError(
            f"limb axis {limb} must divide kql={st.kql} and "
            f"kqlp={st.kql + st.kp}; size the modulus chain to the mesh")


def _table_view(**fields) -> FusedKSTables:
    """A FusedKSTables with only the fields one kernel reads."""
    blank = {f.name: None for f in dataclasses.fields(FusedKSTables)}
    return FusedKSTables(**{**blank, "t_is_one": True, **fields})


def shard_view(st: ShardedFusedTables, limb: int, idx: int,
               device) -> ShardTables:
    """Shard idx of `limb`'s views on `device` (cached in st.views)."""
    device = torch.device(device)
    cache_key = (limb, idx, str(device))
    if cache_key in st.views:
        return st.views[cache_key]
    require_divisible(st, limb)
    f = st.fused
    kql, kp = f.kql, f.kp
    kql_loc, rows = kql // limb, (kql + kp) // limb
    q0, tau0 = idx * kql_loc, idx * rows
    on = lambda t: t.to(device).contiguous()
    qlp = f.basis_qlp.to(device)
    cut = lambda t, lo, n: on(t[lo:lo + n])
    k_full = f.k_q_full

    def key_rows(k):
        q_part = k[:f.nd, tau0:min(tau0 + rows, kql)]
        p_lo, p_hi = max(tau0, kql) - kql, tau0 + rows - kql
        return on(torch.cat([q_part, k[:f.nd, k_full + p_lo:k_full + p_hi]],
                            1))

    view = ShardTables(
        q=_table_view(
            basis_qlp=qlp.slice(q0, q0 + kql_loc),
            basis_ql=qlp.slice(q0, q0 + kql_loc),
            bhatinv_q=cut(f.bhatinv_q, q0, kql_loc),
            bhatinv_q_sh=cut(f.bhatinv_q_sh, q0, kql_loc),
            k1_scale=cut(f.k1_scale, q0, kql_loc),
            k1_scale_sh=cut(f.k1_scale_sh, q0, kql_loc),
            pinv_q=cut(f.pinv_q, q0, kql_loc),
            pinv_q_sh=cut(f.pinv_q_sh, q0, kql_loc),
            kql=kql_loc, kp=0, nd=f.nd, alpha=f.alpha, k_q_full=k_full),
        p=_table_view(
            basis_qlp=qlp, basis_p=qlp.slice(kql, kql + kp),
            pscale=on(f.pscale), pscale_sh=on(f.pscale_sh),
            k45_scale=on(f.k45_scale), k45_scale_sh=on(f.k45_scale_sh),
            kql=kql, kp=kp, nd=f.nd, alpha=f.alpha, k_q_full=k_full),
        basis_qlp=qlp.slice(tau0, tau0 + rows),
        conv_w=on(f.conv_w[:, :, tau0:tau0 + rows]),
        conv_w_sh=on(f.conv_w_sh[:, :, tau0:tau0 + rows]),
        pconv_w=on(f.pconv_w[:, q0:q0 + kql_loc]),
        pconv_w_sh=on(f.pconv_w_sh[:, q0:q0 + kql_loc]),
        keys=tuple(key_rows(k) for k in (st.key.bv, st.key.bv_sh, st.key.av,
                                          st.key.av_sh)),
        q0=q0, tau0=tau0, kql=kql, kql_real=st.kql_real, nd=f.nd,
        alpha=f.alpha)
    st.views[cache_key] = view
    return view


def shard_views(st: ShardedFusedTables, mesh: Mesh,
                axis: str = "limb") -> list:
    """Every mesh position's views, in mesh order."""
    return [shard_view(st, mesh.shape[axis], c[axis], dev)
            for c, dev in zip(mesh.coords(), mesh.flat)]


# ---------------------------------------------------------------------------
# kernels n, o, p: wrappers (the plain twin for a CPU tensor, else the
# kernel or an error)
# ---------------------------------------------------------------------------

def _log_n(v: ShardTables) -> int:
    return v.basis_qlp.ring_dim.bit_length() - 1


def conv_digits_rows(y_pad: torch.Tensor, v: ShardTables) -> torch.Tensor:
    """n: y_pad [nd, alpha, N] COEFF (the gathered y, each digit's rows
    zero-padded) -> [nd, kqlp_loc, N] COEFF, every digit extended to the
    shard's Q_l*P rows (zero on the digit's own rows). The JAX kernel's
    rows are tau-major (tau, j); these are digit-major."""
    if y_pad.device.type == "cpu":
        return _conv_digits_rows_ref(y_pad, v)
    nd, alpha, rows = v.conv_w.shape
    ks_fused._check("conv_digits_rows", v, y_pad=(y_pad, (nd, alpha)))
    n = y_pad.shape[-1]
    out = y_pad.new_empty((nd, rows, n))
    _build.launch("sharded", "conv_digits_rows", y_pad, v.conv_w,
                  v.conv_w_sh, v.basis_qlp.q, out, nd, alpha, rows, n)
    return out


def _conv_digits_rows_ref(y_pad, v: ShardTables):
    return torch.stack([_mod_matmul_rowmod_ref(y_pad[j], v.conv_w[j],
                                               v.basis_qlp.q)
                        for j in range(v.nd)])


def conv_p_to_q_rows(pc: torch.Tensor, v: ShardTables) -> torch.Tensor:
    """o: pc [2, kp, N] COEFF (INTT(ext's P rows) * (P/p_i)^-1) ->
    [2, kql_loc, N] COEFF, the P -> Q conversion onto the shard's Q rows."""
    if pc.device.type == "cpu":
        return _conv_p_to_q_rows_ref(pc, v)
    kp, rows = v.pconv_w.shape
    ks_fused._check("conv_p_to_q_rows", v, pc=(pc, (2, kp)))
    n = pc.shape[-1]
    out = pc.new_empty((2, rows, n))
    _build.launch("sharded", "conv_p_to_q_rows", pc, v.pconv_w,
                  v.pconv_w_sh, v.q.basis_ql.q, out, 2, kp, rows, n)
    return out


def _conv_p_to_q_rows_ref(pc, v: ShardTables):
    return _mod_matmul_rowmod_ref(pc, v.pconv_w, v.q.basis_ql.q)


def ntt_keymul_acc_rows(conv: torch.Tensor, c2: torch.Tensor,
                        v: ShardTables) -> torch.Tensor:
    """p: conv [nd, kqlp_loc, N] COEFF (n's output) and c2 [kql, N] EVAL
    (gathered, all Q rows) -> ext [2, kqlp_loc, N] EVAL over the shard's
    Q_l*P rows: sum_j s_j * (bv_j, av_j), s_j = c2 on digit j's own rows
    (by global row), else the NTT of conv[j]."""
    if conv.device.type == "cpu":
        return _ntt_keymul_acc_rows_ref(conv, c2, v)
    nd, rows = v.nd, v.basis_qlp.k
    ks_fused._check("ntt_keymul_acc_rows", v, conv=(conv, (nd, rows)),
                    c2=(c2, (v.kql,)),
                    **{f"key{i}": (k, (nd, rows))
                       for i, k in enumerate(v.keys)})
    scratch = torch.empty_like(conv)
    ext = conv.new_empty((2, rows, conv.shape[-1]))
    b = v.basis_qlp
    _build.launch("sharded", "ntt_keymul_acc_rows", conv, c2, *v.keys,
                  scratch, ext, b.psi_br, b.psi_br_sh, b.q, nd, v.alpha,
                  rows, v.tau0, v.kql_real, _log_n(v))
    return ext


def take_own(s: torch.Tensor, c2: torch.Tensor, v: ShardTables,
             j: int) -> torch.Tensor:
    """s [kqlp_loc, N] with the rows that are digit j's own (by global row:
    [j * alpha, min((j + 1) * alpha, kql_real))) taken from c2 [kql, N]."""
    lo, hi = v.tau0, v.tau0 + s.shape[0]
    own_lo = max(j * v.alpha, lo)
    own_hi = min((j + 1) * v.alpha, v.kql_real, hi)
    if own_lo >= own_hi:
        return s
    return torch.cat([s[:own_lo - lo], c2[own_lo:own_hi], s[own_hi - lo:]])


def _ntt_keymul_acc_rows_ref(conv, c2, v: ShardTables):
    b = v.basis_qlp
    bv, bv_sh, av, av_sh = v.keys
    acc0 = acc1 = None
    for j in range(v.nd):
        s = take_own(_ntt_fwd_ref(conv[j], b), c2, v, j)
        t0 = mo.mul_mod_shoup(s, bv[j], bv_sh[j], b.q)
        t1 = mo.mul_mod_shoup(s, av[j], av_sh[j], b.q)
        acc0 = t0 if acc0 is None else mo.add_mod(acc0, t0, b.q)
        acc1 = t1 if acc1 is None else mo.add_mod(acc1, t1, b.q)
    return torch.stack([acc0, acc1])


# ---------------------------------------------------------------------------
# the body, and its run over the mesh
# ---------------------------------------------------------------------------

def mult_relin_fused_local(a0, a1, b0, b1, views) -> tuple:
    """One limb group: a0, a1, b0, b1 are lists of the shards' [kql_loc, N]
    EVAL blocks and views their ShardTables; returns the lists of the two
    output elements' blocks. Three stages with a gather between each."""
    c2y = [ks_fused.tensor_intt(x1, y1, v.q)
           for x1, y1, v in zip(a1, b1, views)]
    c2 = all_gather([c for c, _ in c2y])
    y = all_gather([y for _, y in c2y])
    ext = [ntt_keymul_acc_rows(
        conv_digits_rows(ks_fused._pad_digits(yy, v), v), cc, v)
        for yy, cc, v in zip(y, c2, views)]
    ext_all = all_gather(ext, 1)                             # [2, kqlp, N]
    outs = []
    for e, x0, x1, y0, y1, v in zip(ext_all, a0, a1, b0, b1, views):
        convq = conv_p_to_q_rows(ks_fused.intt_scale(e, v.p, p_rows=True), v)
        outs.append(ks_fused.ntt_submul_final(convq, e, x0, x1, y0, y1, v.q,
                                              ext_off=v.q0))
    return [o[0] for o in outs], [o[1] for o in outs]


def mult_relin_sharded(a0, a1, b0, b1, st: ShardedFusedTables, mesh: Mesh,
                       axis: str = "limb") -> tuple:
    """Tensor product + relinearization of sharded ciphertext elements.

    a0, a1, b0, b1: sharded values (lists in mesh order) of [kql_loc, N]
    EVAL blocks, or [b, kql_loc, N] with a batch per dp row; returns the
    two output elements in the same layout. Every limb group runs its own
    pair."""
    views = shard_views(st, mesh, axis)
    return run_groups(
        lambda pos, *args: mult_relin_fused_local(
            *args, [views[p] for p in pos]),
        (a0, a1, b0, b1), mesh, axis)
