"""Fused HYBRID key switching: the five-kernel chains on CUDA.

Counterpart of `openfhe_tpu/pke/keyswitch/ks_fused.py` (`mult_relin_fused`,
`keyswitch_core_fused` and their tables; reference analogs:
keyswitch-hybrid.cpp EvalKeySwitchPrecomputeCore / EvalFastKeySwitchCore,
DCRTPolyImpl::ApproxModDown, rns-leveledshe.cpp EvalMult). One EvalMult of
two 2-element ciphertexts at a level with kql Q towers is five kernel
calls of `csrc/ks_fused.cu`:

  tensor_intt       (K1t) c2 = a1*b1 and y = INTT(c2) * (B_j/b_i)^-1
  conv_digits       (K2)  every digit of y extended to all Q_l*P towers
  ntt_keymul_acc    (K3)  ext = sum_j s_j * (bv_j, av_j), s_j = c2 on the
                          digit's own towers, else NTT of the extension
  intt_conv_p       (K45) INTT(ext's P rows) * (P/p_i)^-1 * t^-1, then
                          P -> Q_l
  ntt_submul_final  (K6f) out = tensor terms + (ext - NTT(convq)) * P^-1

Every other key switch (Relinearize, KeySwitch, every automorphism) is
`keyswitch_core_fused` on one polynomial c2, also five calls: K1t and K6f
give way to

  intt_scale        (K1)  y = INTT(c2) * (B_j/b_i)^-1; the same kernel
                          does K4's INTT of ext's P rows (`p_rows`)
  ntt_subscale      (K6)  out = (ext - t * NTT(convq)) * P^-1, plus an
                          optional addend per element (the caller's final
                          add: Relinearize's e0, e1; an automorphism's or
                          KeySwitch's c0)

Every step is exact modular arithmetic on canonical residues, so the
words equal the unfused chain's (`hybrid.keyswitch_core`, with the tensor
product for EvalMult).

Tables are canonical residues with Shoup companions, like
`rns_tools.SwitchTables`; the JAX package's int8 Karatsuba limb stacks
and f32 ratios are the TPU's number scheme and have no counterpart here.
There is no bucket padding (`bucket_size`, `pad_to`, `kql_real`): XLA
compiles once per shape, but the CUDA kernels take the tower counts as
runtime arguments, so tables are built for each level's real size_ql.
BGV's noise scale t (`ns_int`) reaches only these tables and the two
kernels that read it (`intt_conv_p` through t^-1 in its scale,
`ntt_subscale`); no context of the port sets it yet.

Each kernel has a wrapper and its plain twin (`_..._ref`) here. The
wrapper runs the twin only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises. K1t, K3, K45, K6 and K6f run on the
cluster NTT (`csrc/ntt_cluster.cuh`) where `ops.ntt.cluster_geometry`
takes the ring (2^4 <= N <= 2^17): K1t, K3, K6 and K6f in one launch
each, K45 in two. Their former forms on the staged NTT passes,
`tensor_intt_staged`, `ntt_keymul_acc_staged`, `intt_conv_p_staged`,
`ntt_subscale_staged` and `ntt_submul_final_staged`, serve every other
ring (the choice reads the ring alone) and are the yardstick the cluster
forms are held against on the card. K2 reads y's digits in place; its
former form `conv_digits_rowmod` takes them zero-padded (`_pad_digits`)
and is its yardstick. K1 (`intt_scale`) still runs on the staged passes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from openfhe_tpu_torch import _build
from openfhe_tpu_torch.lattice.basis import Basis
from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.ops.modmatmul import _mod_matmul_rowmod_ref
from openfhe_tpu_torch.ops.ntt import (_ntt_fwd_ref, _ntt_inv_ref,
                                      cluster_geometry)


@dataclasses.dataclass(frozen=True)
class FusedKSTables:
    """Tables of the fused chain for one level (kql Q towers, kp P towers,
    nd digits of alpha towers). Per-tower constants are [k, 1] columns;
    every `_sh` is the Shoup companion of the table before it."""
    basis_qlp: Basis             # Q_l then P: moduli, twiddles, N^-1
    basis_ql: Basis
    basis_p: Basis
    bhatinv_q: torch.Tensor      # [kql, 1] (B_j/b_i)^-1 mod b_i, i in digit j
    bhatinv_q_sh: torch.Tensor
    k1_scale: torch.Tensor       # [kql, 1] N^-1 * bhatinv_q, K1t's last pass
    k1_scale_sh: torch.Tensor
    conv_w: torch.Tensor         # [nd, alpha, kqlp] [B_j/b_i]_{q_tau}, zero
    conv_w_sh: torch.Tensor      #   on the digit's own rows and past its end
    pscale: torch.Tensor         # [kp, 1] (P/p_i)^-1 * t^-1 mod p_i
    pscale_sh: torch.Tensor
    k45_scale: torch.Tensor      # [kp, 1] N^-1 * pscale, K45's last pass
    k45_scale_sh: torch.Tensor
    pconv_w: torch.Tensor        # [kp, kql] [P/p_j]_{q_i}
    pconv_w_sh: torch.Tensor
    t_modq: torch.Tensor         # [kql, 1] t mod q_i (K6)
    t_modq_sh: torch.Tensor
    pinv_q: torch.Tensor         # [kql, 1] P^-1 mod q_i
    pinv_q_sh: torch.Tensor
    kql: int
    kp: int
    nd: int
    alpha: int
    k_q_full: int
    t_is_one: bool = True        # ns_int == 1: K6 skips the t multiply


def _pair(vals, mods, device):
    """Residues and their Shoup companions, as int32 tensors of vals'
    shape; mods broadcasts against vals (numpy rules)."""
    v = np.asarray(vals, np.uint64)
    sh = (v << np.uint64(32)) // np.asarray(mods, np.uint64)
    return mo.u32_tensor(v, device), mo.u32_tensor(sh, device)


def make_fused_ks_tables(basis_qlp: Basis, size_ql: int, k_q_full: int,
                         num_parts: int, ns_int: int = 1) -> FusedKSTables:
    """Host precompute (Python ints) for the level with `size_ql` Q towers;
    `basis_qlp` is Q_l followed by P, `k_q_full` the full chain's Q tower
    count and `num_parts` its digit count. `ns_int` is BGV's noise scale
    t (1 for CKKS): the mod-down then returns (x - t*[x*t^-1]_P) / P."""
    dev = basis_qlp.device
    n = basis_qlp.ring_dim
    kql = size_ql
    mq = basis_qlp.moduli[:kql]
    mp = basis_qlp.moduli[kql:]
    mqlp = basis_qlp.moduli
    kp, kqlp = len(mp), len(mqlp)
    alpha = -(-k_q_full // num_parts)
    nd = min(-(-kql // alpha), num_parts)
    col = lambda vals, mods: _pair(np.reshape(vals, (-1, 1)),
                                   np.reshape(mods, (-1, 1)), dev)

    # K1t: the digit-local CRT lift inverse, alone and with N^-1 folded in
    bhat = [math.prod(mq[j * alpha:(j + 1) * alpha]) for j in range(nd)]
    bhatinv = [pow(bhat[i // alpha] // q % q, -1, q)
               for i, q in enumerate(mq)]
    k1 = [v * pow(n, -1, q) % q for v, q in zip(bhatinv, mq)]
    # K2: W[j, i, tau] = [B_j / b_i]_{q_tau}, zero on digit j's own rows
    w = np.zeros((nd, alpha, kqlp), np.uint64)
    for j in range(nd):
        start, end = j * alpha, min((j + 1) * alpha, kql)
        for i, b in enumerate(mq[start:end]):
            for tau, qt in enumerate(mqlp):
                if not start <= tau < end:
                    w[j, i, tau] = bhat[j] // b % qt
    # K45: (P/p_i)^-1 * t^-1 (and with N^-1), W5[j, i] = [P / p_j]_{q_i}
    big_p = math.prod(mp)
    pscale = [pow(big_p // p % p, -1, p) * pow(ns_int % p, -1, p) % p
              for p in mp]
    k45 = [v * pow(n, -1, p) % p for v, p in zip(pscale, mp)]
    w5 = np.array([[big_p // p % q for q in mq] for p in mp], np.uint64)
    # K6 / K6f: t mod q_i and P^-1 mod q_i
    tq = [ns_int % q for q in mq]
    pinv = [pow(big_p % q, -1, q) for q in mq]
    return FusedKSTables(
        basis_qlp, basis_qlp.slice(0, kql), basis_qlp.slice(kql, kqlp),
        *col(bhatinv, mq), *col(k1, mq),
        *_pair(w, np.reshape(mqlp, (1, 1, -1)), dev),
        *col(pscale, mp), *col(k45, mp),
        *_pair(w5, np.reshape(mq, (1, -1)), dev),
        *col(tq, mq), *col(pinv, mq),
        kql=kql, kp=kp, nd=nd, alpha=alpha, k_q_full=k_q_full,
        t_is_one=ns_int == 1)


# ---------------------------------------------------------------------------
# wrappers: the plain twin for a CPU tensor, else the kernel or an error
# ---------------------------------------------------------------------------

def _check(name: str, tabs: FusedKSTables, **tensors) -> None:
    """Each keyword is (tensor, leading shape): the tensor must be a
    contiguous int32 [*lead, N] on the tables' CUDA device."""
    n = tabs.basis_qlp.ring_dim
    for arg, (t, lead) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: no kernel for device {t.device}")
        if t.device != tabs.basis_qlp.device:
            raise ValueError(f"{name}: {arg} on {t.device}, tables on "
                             f"{tabs.basis_qlp.device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous int32 "
                             "tensor")
        if tuple(t.shape) != tuple(lead) + (n,):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(lead) + (n,)}")


def _log_n(tabs: FusedKSTables) -> int:
    return tabs.basis_qlp.ring_dim.bit_length() - 1


def tensor_intt(a1: torch.Tensor, b1: torch.Tensor, tabs: FusedKSTables):
    """K1t: a1, b1 [kql, N] EVAL -> (c2 = a1*b1 [kql, N] EVAL,
    y = INTT(c2) * (B_j/b_i)^-1 [kql, N] COEFF). On the card one launch of
    the cluster kernel, or the staged one for rings it does not take."""
    if a1.device.type == "cpu":
        return _tensor_intt_ref(a1, b1, tabs)
    entry = ("tensor_intt" if cluster_geometry(tabs.basis_qlp.ring_dim)
             else "tensor_intt_staged")
    return _tensor_intt_cu(a1, b1, tabs, entry)


def tensor_intt_staged(a1: torch.Tensor, b1: torch.Tensor,
                       tabs: FusedKSTables):
    """K1t on the staged NTT passes, any ring; CUDA tensors only."""
    return _tensor_intt_cu(a1, b1, tabs, "tensor_intt_staged")


def _tensor_intt_cu(a1, b1, tabs: FusedKSTables, entry: str):
    kql = tabs.kql
    _check(entry, tabs, a1=(a1, (kql,)), b1=(b1, (kql,)))
    c2, y = torch.empty_like(a1), torch.empty_like(a1)
    bq = tabs.basis_ql
    red = () if entry.endswith("_staged") else (bq.red64,)
    _build.launch("ks_fused", entry, a1, b1, c2, y, bq.ipsi_br,
                  bq.ipsi_br_sh, bq.q, tabs.k1_scale, tabs.k1_scale_sh, *red,
                  kql, _log_n(tabs))
    return c2, y


def _tensor_intt_ref(a1, b1, tabs: FusedKSTables):
    bq = tabs.basis_ql
    c2 = mo.mul_mod(a1, b1, bq.q)
    y = mo.mul_mod_shoup(_ntt_inv_ref(c2, bq), tabs.bhatinv_q,
                         tabs.bhatinv_q_sh, bq.q)
    return c2, y


def intt_scale(x: torch.Tensor, tabs: FusedKSTables,
               p_rows: bool = False) -> torch.Tensor:
    """INTT times a per-tower constant, in one of the two forms of the
    JAX package's `_intt_scale_pairs` / `_intt_scale`:

      K1 (p_rows False): x [kql, N] EVAL over Q_l ->
         y = INTT(x) * (B_j/b_i)^-1 [kql, N] COEFF;
      K4 (p_rows True):  x [E, kql + kp, N] EVAL (ext) ->
         INTT(x[:, kql:]) * (P/p_i)^-1 * t^-1 [E, kp, N] COEFF, the P rows
         read in place.
    """
    if x.device.type == "cpu":
        return _intt_scale_ref(x, tabs, p_rows)
    kql, kp = tabs.kql, tabs.kp
    if p_rows:
        lead = tuple(x.shape[:-2])
        _check("intt_scale", tabs, x=(x, lead + (kql + kp,)))
        k, in_rows, in_off = kp, kql + kp, kql
        basis, scale, scale_sh = (tabs.basis_p, tabs.k45_scale,
                                  tabs.k45_scale_sh)
    else:
        lead = ()
        _check("intt_scale", tabs, x=(x, (kql,)))
        k, in_rows, in_off = kql, kql, 0
        basis, scale, scale_sh = (tabs.basis_ql, tabs.k1_scale,
                                  tabs.k1_scale_sh)
    out = x.new_empty(lead + (k, x.shape[-1]))
    _build.launch("ks_fused", "intt_scale", x, out, basis.ipsi_br,
                  basis.ipsi_br_sh, basis.q, scale, scale_sh, math.prod(lead),
                  k, in_rows, in_off, _log_n(tabs))
    return out


def _intt_scale_ref(x, tabs: FusedKSTables, p_rows: bool = False):
    if p_rows:
        b, c, c_sh = tabs.basis_p, tabs.pscale, tabs.pscale_sh
        x = x[..., tabs.kql:, :]
    else:
        b, c, c_sh = tabs.basis_ql, tabs.bhatinv_q, tabs.bhatinv_q_sh
    return mo.mul_mod_shoup(_ntt_inv_ref(x, b), c, c_sh, b.q)


def conv_digits(y: torch.Tensor, tabs: FusedKSTables) -> torch.Tensor:
    """K2: y [kql, N] COEFF -> [nd, kqlp, N] COEFF, every digit j (rows
    j * alpha .. min((j + 1) * alpha, kql) - 1 of y) extended to all
    Q_l*P towers, sum_i y[j * alpha + i] * W[j, i, tau] mod q_tau, zero on
    the digit's own rows. On the card one launch of the conversion kernel,
    which reads the digits in place."""
    if y.device.type == "cpu":
        return _conv_digits_ref(y, tabs)
    nd, alpha, kqlp = tabs.conv_w.shape
    _check("conv_digits", tabs, y=(y, (tabs.kql,)))
    n = y.shape[-1]
    out = y.new_empty((nd, kqlp, n))
    b = tabs.basis_qlp
    _build.launch("ks_fused", "conv_digits", y, tabs.conv_w, tabs.conv_w_sh,
                  b.q, b.red64, out, nd, alpha, tabs.kql, kqlp, n)
    return out


def conv_digits_rowmod(y_pad: torch.Tensor,
                       tabs: FusedKSTables) -> torch.Tensor:
    """K2's former form: y_pad [nd, alpha, N] (`_pad_digits`) -> the
    output of `conv_digits`, by rowmod_core.cuh's conversion over the
    padded rows; CUDA tensors only."""
    nd, alpha, kqlp = tabs.conv_w.shape
    _check("conv_digits_rowmod", tabs, y_pad=(y_pad, (nd, alpha)))
    n = y_pad.shape[-1]
    out = y_pad.new_empty((nd, kqlp, n))
    _build.launch("ks_fused", "conv_digits_rowmod", y_pad, tabs.conv_w,
                  tabs.conv_w_sh, tabs.basis_qlp.q, out, nd, alpha, kqlp, n)
    return out


def _conv_digits_ref(y, tabs: FusedKSTables):
    y_pad = _pad_digits(y, tabs)
    return torch.stack([_mod_matmul_rowmod_ref(y_pad[j], tabs.conv_w[j],
                                               tabs.basis_qlp.q)
                        for j in range(tabs.nd)])


def ntt_keymul_acc(conv, c2, bv, bv_sh, av, av_sh,
                   tabs: FusedKSTables) -> torch.Tensor:
    """K3: conv [nd, kqlp, N] COEFF, c2 [kql, N] EVAL and the key halves
    [>= nd, k_q_full + kp, N] (with companions) -> ext [2, kqlp, N] EVAL,
    (sum_j s_j * bv_j, sum_j s_j * av_j) over Q_l*P. On the card one
    launch of the cluster kernel, or the staged one for rings it does not
    take."""
    if conv.device.type == "cpu":
        return _ntt_keymul_acc_ref(conv, c2, bv, bv_sh, av, av_sh, tabs)
    entry = ("ntt_keymul_acc" if cluster_geometry(tabs.basis_qlp.ring_dim)
             else "ntt_keymul_acc_staged")
    return _ntt_keymul_acc_cu(conv, c2, bv, bv_sh, av, av_sh, tabs, entry)


def ntt_keymul_acc_staged(conv, c2, bv, bv_sh, av, av_sh,
                          tabs: FusedKSTables) -> torch.Tensor:
    """K3 on the staged NTT passes, any ring; CUDA tensors only."""
    return _ntt_keymul_acc_cu(conv, c2, bv, bv_sh, av, av_sh, tabs,
                              "ntt_keymul_acc_staged")


def _ntt_keymul_acc_cu(conv, c2, bv, bv_sh, av, av_sh, tabs: FusedKSTables,
                       entry: str) -> torch.Tensor:
    kql, kp, nd = tabs.kql, tabs.kp, tabs.nd
    kqlp = kql + kp
    key = (bv.shape[0], tabs.k_q_full + kp)
    if bv.dim() != 3 or key[0] < nd:
        raise ValueError(f"{entry}: key shape {tuple(bv.shape)} has fewer "
                         f"than {nd} digits")
    _check(entry, tabs, conv=(conv, (nd, kqlp)), c2=(c2, (kql,)),
           bv=(bv, key), bv_sh=(bv_sh, key), av=(av, key),
           av_sh=(av_sh, key))
    ext = conv.new_empty((2, kqlp, conv.shape[-1]))
    scratch = (torch.empty_like(conv),) if entry.endswith("_staged") else ()
    b = tabs.basis_qlp
    _build.launch("ks_fused", entry, conv, c2, bv, bv_sh, av, av_sh,
                  *scratch, ext, b.psi_br, b.psi_br_sh, b.q, nd, tabs.alpha,
                  kql, kp, tabs.k_q_full, _log_n(tabs))
    return ext


def _ntt_keymul_acc_ref(conv, c2, bv, bv_sh, av, av_sh, tabs: FusedKSTables):
    kql, kf, alpha = tabs.kql, tabs.k_q_full, tabs.alpha
    b = tabs.basis_qlp
    rows = lambda k, j: torch.cat([k[j, :kql], k[j, kf:]])   # key_row
    acc0 = acc1 = None
    for j in range(tabs.nd):
        start, end = j * alpha, min((j + 1) * alpha, kql)
        s = _ntt_fwd_ref(conv[j], b)
        s = torch.cat([s[:start], c2[start:end], s[end:]])
        t0 = mo.mul_mod_shoup(s, rows(bv, j), rows(bv_sh, j), b.q)
        t1 = mo.mul_mod_shoup(s, rows(av, j), rows(av_sh, j), b.q)
        acc0 = t0 if acc0 is None else mo.add_mod(acc0, t0, b.q)
        acc1 = t1 if acc1 is None else mo.add_mod(acc1, t1, b.q)
    return torch.stack([acc0, acc1])


def intt_conv_p(ext: torch.Tensor, tabs: FusedKSTables) -> torch.Tensor:
    """K45: ext [2, kqlp, N] EVAL -> [2, kql, N] COEFF, the P -> Q_l
    conversion of INTT(ext[:, kql:]) * (P/p_i)^-1. On the card the cluster
    INTT and the conversion (two launches), or the staged form for rings
    the cluster NTT does not take."""
    if ext.device.type == "cpu":
        return _intt_conv_p_ref(ext, tabs)
    entry = ("intt_conv_p" if cluster_geometry(tabs.basis_qlp.ring_dim)
             else "intt_conv_p_staged")
    return _intt_conv_p_cu(ext, tabs, entry)


def intt_conv_p_staged(ext: torch.Tensor,
                       tabs: FusedKSTables) -> torch.Tensor:
    """K45 on the staged NTT passes, any ring; CUDA tensors only."""
    return _intt_conv_p_cu(ext, tabs, "intt_conv_p_staged")


def _intt_conv_p_cu(ext: torch.Tensor, tabs: FusedKSTables,
                    entry: str) -> torch.Tensor:
    kql, kp = tabs.kql, tabs.kp
    _check(entry, tabs, ext=(ext, (2, kql + kp)))
    n = ext.shape[-1]
    pc = ext.new_empty((2, kp, n))
    out = ext.new_empty((2, kql, n))
    bp, bq = tabs.basis_p, tabs.basis_ql
    red = () if entry.endswith("_staged") else (bq.red64,)
    _build.launch("ks_fused", entry, ext, pc, out, bp.ipsi_br,
                  bp.ipsi_br_sh, bp.q, tabs.k45_scale, tabs.k45_scale_sh,
                  tabs.pconv_w, tabs.pconv_w_sh, bq.q, *red, kql, kp,
                  _log_n(tabs))
    return out


def _intt_conv_p_ref(ext, tabs: FusedKSTables):
    return _mod_matmul_rowmod_ref(_intt_scale_ref(ext, tabs, p_rows=True),
                                  tabs.pconv_w, tabs.basis_ql.q)


def ntt_submul_final(convq, ext, a0, a1, b0, b1, tabs: FusedKSTables,
                     ext_off: int = 0) -> torch.Tensor:
    """K6f: convq [2, kql, N] COEFF, ext [2, R, N] EVAL whose rows ext_off
    .. ext_off + kql - 1 are the Q_l rows (R = kqlp and ext_off = 0 on one
    card; the gathered ext and the shard's first Q row when sharded) and
    the inputs a0, a1, b0, b1 [kql, N] EVAL -> [2, kql, N] EVAL:
    d_e = (ext[e, ext_off:][:kql] - NTT(convq[e])) * P^-1, c0 = a0 b0,
    c2 = a1 b1, c1 = (a0 + a1)(b0 + b1) - c0 - c2, out = (c0 + d_0,
    c1 + d_1). On the card one launch of the cluster kernel, or the staged
    one for rings it does not take; ext is read in place."""
    if convq.device.type == "cpu":
        return _ntt_submul_final_ref(convq, ext, a0, a1, b0, b1, tabs,
                                     ext_off)
    entry = ("ntt_submul_final" if cluster_geometry(tabs.basis_qlp.ring_dim)
             else "ntt_submul_final_staged")
    return _ntt_submul_final_cu(convq, ext, a0, a1, b0, b1, tabs, ext_off,
                                entry)


def ntt_submul_final_staged(convq, ext, a0, a1, b0, b1, tabs: FusedKSTables,
                            ext_off: int = 0) -> torch.Tensor:
    """K6f on the staged NTT passes, any ring; CUDA tensors only."""
    return _ntt_submul_final_cu(convq, ext, a0, a1, b0, b1, tabs, ext_off,
                                "ntt_submul_final_staged")


def _ntt_submul_final_cu(convq, ext, a0, a1, b0, b1, tabs: FusedKSTables,
                         ext_off: int, entry: str) -> torch.Tensor:
    kql = tabs.kql
    rows = ext.shape[1] if ext.dim() == 3 else -1
    if ext_off < 0 or rows < ext_off + kql:
        raise ValueError(f"{entry}: ext of shape {tuple(ext.shape)} has no "
                         f"rows {ext_off} .. {ext_off + kql - 1}")
    _check(entry, tabs, convq=(convq, (2, kql)), ext=(ext, (2, rows)),
           a0=(a0, (kql,)), a1=(a1, (kql,)), b0=(b0, (kql,)),
           b1=(b1, (kql,)))
    out = torch.empty_like(convq)
    bq = tabs.basis_ql
    tail = ((torch.empty_like(convq), out) if entry.endswith("_staged")
            else (out,))
    red = () if entry.endswith("_staged") else (bq.red64,)
    _build.launch("ks_fused", entry, convq, ext, a0, a1, b0, b1, *tail,
                  bq.psi_br, bq.psi_br_sh, bq.q, tabs.pinv_q, tabs.pinv_q_sh,
                  *red, kql, rows, ext_off, _log_n(tabs))
    return out


def _ntt_submul_final_ref(convq, ext, a0, a1, b0, b1, tabs: FusedKSTables,
                          ext_off: int = 0):
    bq = tabs.basis_ql
    q = bq.q
    c0 = mo.mul_mod(a0, b0, q)
    c2 = mo.mul_mod(a1, b1, q)
    cross = mo.mul_mod(mo.add_mod(a0, a1, q), mo.add_mod(b0, b1, q), q)
    c1 = mo.sub_mod(mo.sub_mod(cross, c0, q), c2, q)
    xq = ext[:, ext_off:ext_off + tabs.kql]
    d = mo.mul_mod_shoup(mo.sub_mod(xq, _ntt_fwd_ref(convq, bq), q),
                         tabs.pinv_q, tabs.pinv_q_sh, q)
    return torch.stack([mo.add_mod(c0, d[0], q), mo.add_mod(c1, d[1], q)])


def ntt_subscale(convq: torch.Tensor, ext: torch.Tensor, tabs: FusedKSTables,
                 add0: torch.Tensor | None = None,
                 add1: torch.Tensor | None = None) -> torch.Tensor:
    """K6: convq [2, kql, N] COEFF and ext [2, kqlp, N] EVAL ->
    [2, kql, N] EVAL, out[e] = (ext[e, :kql] - t * NTT(convq[e])) * P^-1
    (t = 1 unless the tables were made with ns_int), plus add_e [kql, N]
    EVAL where it is given (the caller's final add: Relinearize's (e0, e1),
    an automorphism's or KeySwitch's c0). On the card one launch of the
    cluster kernel, or the staged one for rings it does not take."""
    if convq.device.type == "cpu":
        _check_addends("ntt_subscale", tabs, add0, add1)
        return _ntt_subscale_ref(convq, ext, tabs, add0, add1)
    entry = ("ntt_subscale" if cluster_geometry(tabs.basis_qlp.ring_dim)
             else "ntt_subscale_staged")
    return _ntt_subscale_cu(convq, ext, tabs, add0, add1, entry)


def ntt_subscale_staged(convq: torch.Tensor, ext: torch.Tensor,
                        tabs: FusedKSTables,
                        add0: torch.Tensor | None = None,
                        add1: torch.Tensor | None = None) -> torch.Tensor:
    """K6 on the staged NTT passes, any ring; CUDA tensors only."""
    return _ntt_subscale_cu(convq, ext, tabs, add0, add1,
                            "ntt_subscale_staged")


def _check_addends(name: str, tabs: FusedKSTables, *adds) -> None:
    """Each addend is None or a [kql, N] tensor (the twin's check: `_check`
    holds a CUDA addend to it)."""
    want = (tabs.kql, tabs.basis_qlp.ring_dim)
    for e, add in enumerate(adds):
        if add is not None and tuple(add.shape) != want:
            raise ValueError(f"{name}: add{e} has shape {tuple(add.shape)}, "
                             f"expected {want}")


def _ntt_subscale_cu(convq, ext, tabs: FusedKSTables, add0, add1,
                     entry: str) -> torch.Tensor:
    kql, kp = tabs.kql, tabs.kp
    adds = {f"add{e}": (a, (kql,)) for e, a in enumerate((add0, add1))
            if a is not None}
    _check(entry, tabs, convq=(convq, (2, kql)), ext=(ext, (2, kql + kp)),
           **adds)
    out = torch.empty_like(convq)
    tail = ((torch.empty_like(convq), out) if entry.endswith("_staged")
            else (out,))
    bq = tabs.basis_ql
    _build.launch("ks_fused", entry, convq, ext, *tail, bq.psi_br,
                  bq.psi_br_sh, bq.q, tabs.t_modq, tabs.t_modq_sh,
                  tabs.pinv_q, tabs.pinv_q_sh, add0, add1, kql, kp,
                  int(not tabs.t_is_one), _log_n(tabs))
    return out


def _ntt_subscale_ref(convq, ext, tabs: FusedKSTables, add0=None,
                      add1=None):
    bq = tabs.basis_ql
    s = _ntt_fwd_ref(convq, bq)
    if not tabs.t_is_one:
        s = mo.mul_mod_shoup(s, tabs.t_modq, tabs.t_modq_sh, bq.q)
    out = mo.mul_mod_shoup(mo.sub_mod(ext[:, :tabs.kql], s, bq.q),
                           tabs.pinv_q, tabs.pinv_q_sh, bq.q)
    return torch.stack([o if a is None else mo.add_mod(o, a, bq.q)
                        for o, a in zip(out, (add0, add1))])


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _pad_digits(y: torch.Tensor, tabs: FusedKSTables) -> torch.Tensor:
    """y [kql, N] -> [nd, alpha, N], the last digit zero-padded: the input
    of conv_digits_rowmod and of the sharded kernel n."""
    pad = tabs.nd * tabs.alpha - tabs.kql
    if pad:
        y = torch.cat([y, y.new_zeros((pad, y.shape[-1]))])
    return y.view(tabs.nd, tabs.alpha, y.shape[-1])


def mult_relin_fused(a0, a1, b0, b1, bv, av, bv_sh, av_sh,
                     tabs: FusedKSTables):
    """Tensor product + relinearization as one five-kernel chain.

    a0, a1, b0, b1: [kql, N] EVAL; bv, av (+ companions): the eval key
    [dnum, k_q_full + kp, N]. Returns (o0, o1) [kql, N] EVAL."""
    c2, y = tensor_intt(a1, b1, tabs)
    conv = conv_digits(y, tabs)
    ext = ntt_keymul_acc(conv, c2, bv, bv_sh, av, av_sh, tabs)
    convq = intt_conv_p(ext, tabs)
    out = ntt_submul_final(convq, ext, a0, a1, b0, b1, tabs)
    return out[0], out[1]


def keyswitch_core_fused(c2, bv, av, bv_sh, av_sh, tabs: FusedKSTables,
                         add0=None, add1=None):
    """KeySwitchCore on one polynomial as one five-kernel chain.

    c2: [kql, N] EVAL; bv, av (+ companions): the key-switch key
    [dnum, k_q_full + kp, N]; add0, add1: None or [kql, N] EVAL, added to
    the result by K6. Returns (d0 + add0, d1 + add1) [kql, N] EVAL, the
    words of `hybrid.keyswitch_core`'s unfused chain."""
    y = intt_scale(c2, tabs)
    conv = conv_digits(y, tabs)
    ext = ntt_keymul_acc(conv, c2, bv, bv_sh, av, av_sh, tabs)
    convq = intt_conv_p(ext, tabs)
    out = ntt_subscale(convq, ext, tabs, add0, add1)
    return out[0], out[1]
