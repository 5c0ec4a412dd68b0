"""HYBRID (GHS) key switching, unfused.

Counterpart of `openfhe_tpu/pke/keyswitch/hybrid.py` (reference analog:
keyswitch-hybrid.cpp KeySwitchGenInternal, EvalKeySwitchPrecomputeCore,
EvalFastKeySwitchCoreExt, ApproxModDown).

  * KeyGen digit j: b_j = -a_j*s_new + e_j + P*s_old*mask_j over QP, where
    mask_j zeroes every tower outside digit j.
  * Switch: digit j of c = [c]_{Q_j} extended from the digit's towers to
    Q_l*P (ApproxModUp); inner product with the key digits; ApproxModDown
    divides by P.

At the top level (two digits) the unfused chain runs four forward NTTs,
four inverse NTTs and four base conversions: one of each per digit and
per element of the mod-down. On a CUDA context the level's tables also
carry the fused chain's tables (`HybridTables.fused`): `keyswitch_core`
then runs `ks_fused.keyswitch_core_fused` and EvalMult
`ks_fused.mult_relin_fused`, with the same words.

Hoisted rotations (`eval_fast_rotation_precompute` / `_core`) stay
unfused, as in the JAX package: the digits are extended once and each
rotation permutes them. The extended-basis forms (reference KeySwitchExt,
EvalFastRotationExt, KeySwitchDown) stop before the mod-down and leave
the pair over Q_l*P: `raise_c0_ext`, `eval_fast_rotation_core_ext`,
`mod_down_pair` and `mod_down_first`.

BGV's noise scale t (`ns_int`) multiplies the key's error and reaches the
mod-down tables (t^-1 on the P rows, t after the conversion) and the
fused chain's tables; it is 1 for CKKS and BFV.
"""

from __future__ import annotations

import dataclasses

import torch

from openfhe_tpu_torch.lattice import rns_tools as rt
from openfhe_tpu_torch.lattice.basis import Basis
from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.math import sampling
from openfhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from openfhe_tpu_torch.pke.keys import EvalKey, PrivateKey
from openfhe_tpu_torch.pke.keyswitch import ks_fused


@dataclasses.dataclass(frozen=True)
class PartTables:
    """Per-digit conversion tables at one level."""
    switch: rt.SwitchTables
    digit_basis: Basis
    compl_basis: Basis
    start: int
    end: int


@dataclasses.dataclass(frozen=True)
class HybridTables:
    """All hybrid-KS tables for one ciphertext level (size_ql towers)."""
    parts: tuple                 # tuple[PartTables]
    moddown: rt.ModDownTables
    basis_ql: Basis
    basis_p: Basis
    basis_qlp: Basis
    size_ql: int
    k_q_full: int
    fused: ks_fused.FusedKSTables | None = None   # CUDA tables only


def make_hybrid_tables(basis_q: Basis, basis_p: Basis, size_ql: int,
                       num_parts_full: int, ns_int: int = 1) -> HybridTables:
    """Host precompute for the level with `size_ql` towers (reference:
    rns-cryptoparameters.h m_paramsPartQ / m_paramsComplPartQ). On a CUDA
    device the fused chain's tables come too, as the JAX package builds
    them only where its kernels run."""
    dev = basis_q.device
    k_full = basis_q.k
    alpha = -(-k_full // num_parts_full)
    q_mods = basis_q.moduli[:size_ql]
    p_mods = basis_p.moduli
    num_parts = min(-(-size_ql // alpha), num_parts_full)
    parts = []
    for j in range(num_parts):
        start = j * alpha
        end = min(start + alpha, size_ql)
        compl_basis = (basis_q.slice(0, start)
                       .concat(basis_q.slice(end, size_ql))
                       .concat(basis_p))
        parts.append(PartTables(
            switch=rt.make_switch_tables(q_mods[start:end],
                                         compl_basis.moduli, dev),
            digit_basis=basis_q.slice(start, end), compl_basis=compl_basis,
            start=start, end=end))
    basis_ql = basis_q.slice(0, size_ql)
    basis_qlp = basis_ql.concat(basis_p)
    fused = None
    if dev.type == "cuda":
        fused = ks_fused.make_fused_ks_tables(basis_qlp, size_ql, k_full,
                                              num_parts_full, ns_int=ns_int)
    return HybridTables(
        parts=tuple(parts),
        moddown=rt.make_mod_down_tables(p_mods, q_mods, dev, t=ns_int),
        basis_ql=basis_ql, basis_p=basis_p, basis_qlp=basis_qlp,
        size_ql=size_ql, k_q_full=k_full, fused=fused)


def keyswitch_gen(gen: torch.Generator, s_old: PrivateKey,
                  s_new: PrivateKey, basis_qp: Basis, k_q: int,
                  num_parts: int, p_modq, p_modq_sh,
                  ns_int: int = 1) -> EvalKey:
    """Generate the hybrid KS key s_old -> s_new over QP.

    p_modq(+_sh): [P mod q_i] per Q tower, zero over the P towers; ns_int
    the noise scale (BGV's t, else 1), which multiplies the error.
    """
    n = basis_qp.ring_dim
    alpha = -(-k_q // num_parts)
    ps_old = mo.mul_mod_shoup(s_old.s_qp, p_modq, p_modq_sh, basis_qp.q)
    rows = torch.arange(basis_qp.k, device=basis_qp.device)[:, None]
    bs, as_ = [], []
    for part in range(num_parts):
        a = sampling.uniform_residues(gen, basis_qp)           # EVAL-uniform
        e = ntt_fwd(sampling.to_residues(
            sampling.discrete_gaussian(gen, (n,)), basis_qp), basis_qp)
        if ns_int != 1:
            e = mul_const_int(e, ns_int, basis_qp)
        b = mo.sub_mod(e, mo.mul_mod(a, s_new.s_qp, basis_qp.q), basis_qp.q)
        # + P * s_old on this digit's towers only (the CRT mask)
        start, end = alpha * part, min(alpha * (part + 1), k_q)
        mask = (rows >= start) & (rows < end)
        b = torch.where(mask, mo.add_mod(b, ps_old, basis_qp.q), b)
        bs.append(b)
        as_.append(a)
    return shoup_companions(EvalKey(bv=torch.stack(bs), av=torch.stack(as_),
                                    key_tag=s_new.key_tag), basis_qp.moduli)


def mul_const_int(x: torch.Tensor, c: int, basis: Basis) -> torch.Tensor:
    """x times the integer c (reduced mod each tower), by Shoup."""
    cc, cc_sh = mo.shoup_pair([c % q for q in basis.moduli], basis.moduli,
                              basis.device)
    return mo.mul_mod_shoup(x, cc, cc_sh, basis.q)


def shoup_companions(ek: EvalKey, moduli_qp) -> EvalKey:
    """Attach the Shoup companions floor(v * 2^32 / q) of every key word
    (int32 bit patterns), which the fused chain's key products use. Exact
    in int64: v < q < 2^31."""
    q = torch.tensor([int(m) for m in moduli_qp], dtype=torch.int64,
                     device=ek.bv.device).view(-1, 1)
    sh = lambda v: mo.i32_bits((v.long() << 32) // q)
    return dataclasses.replace(ek, bv_sh=sh(ek.bv), av_sh=sh(ek.av))


def require_companions(ek: EvalKey) -> None:
    """The fused chains' key products need the key's Shoup companions."""
    if ek.bv_sh is None or ek.av_sh is None:
        raise ValueError("the fused key switch needs the key's Shoup "
                         "companions (hybrid.shoup_companions)")


def _decompose_digits(c: torch.Tensor, tabs: HybridTables) -> list:
    """EvalKeySwitchPrecomputeCore: per digit, extend [c]_{Q_j} to Q_l*P.

    c: [kQl, N] EVAL. Returns a list of [kQl + kP, N] EVAL tensors.
    """
    digits = []
    for pt in tabs.parts:
        own_eval = c[pt.start:pt.end]
        own_coeff = ntt_inv(own_eval, pt.digit_basis)
        conv = rt.switch_crt_basis_approx(own_coeff, pt.digit_basis,
                                          pt.compl_basis, pt.switch)
        conv = ntt_fwd(conv, pt.compl_basis)
        # compl_basis is Q_l without the digit's towers, then P
        digits.append(torch.cat([conv[:pt.start], own_eval,
                                 conv[pt.start:]], dim=0))
    return digits


def _key_slice(arr: torch.Tensor, j: int, tabs: HybridTables):
    """Digit j of a key restricted to the Q_l*P towers."""
    if tabs.size_ql == tabs.k_q_full:
        return arr[j]
    return torch.cat([arr[j, :tabs.size_ql], arr[j, tabs.k_q_full:]], dim=0)


def _fast_core_ext(digits: list, ek: EvalKey, tabs: HybridTables):
    """EvalFastKeySwitchCoreExt: (sum_j d_j*b_j, sum_j d_j*a_j) over Q_l*P."""
    q = tabs.basis_qlp.q
    acc0 = acc1 = None
    for j, d in enumerate(digits):
        t0 = mo.mul_mod(d, _key_slice(ek.bv, j, tabs), q)
        t1 = mo.mul_mod(d, _key_slice(ek.av, j, tabs), q)
        acc0 = t0 if acc0 is None else mo.add_mod(acc0, t0, q)
        acc1 = t1 if acc1 is None else mo.add_mod(acc1, t1, q)
    return acc0, acc1


def _mod_down_pair(ext0, ext1, tabs: HybridTables):
    size_ql = tabs.size_ql
    return tuple(rt.approx_mod_down(ext[:size_ql], ext[size_ql:],
                                    tabs.basis_ql, tabs.basis_p,
                                    tabs.moddown)
                 for ext in (ext0, ext1))


def keyswitch_core(c: torch.Tensor, ek: EvalKey, tabs: HybridTables,
                   add0: torch.Tensor | None = None,
                   add1: torch.Tensor | None = None):
    """KeySwitchCore on one polynomial (usually ct[last]): returns
    (delta0, delta1) over Q_l in EVAL, each plus its addend where one is
    given ([size_ql, N] EVAL: the caller's final add). The fused chain when
    the tables carry it (a CUDA context), which needs the key's Shoup
    companions and adds in its last kernel; else the unfused chain."""
    if tabs.fused is not None:
        require_companions(ek)
        return ks_fused.keyswitch_core_fused(c, ek.bv, ek.av, ek.bv_sh,
                                             ek.av_sh, tabs.fused, add0, add1)
    d = _mod_down_pair(*_fast_core_ext(_decompose_digits(c, tabs), ek, tabs),
                       tabs)
    q = tabs.basis_ql.q
    return tuple(x if a is None else mo.add_mod(a, x, q)
                 for x, a in zip(d, (add0, add1)))


def eval_fast_rotation_precompute(c1: torch.Tensor, tabs: HybridTables):
    """Hoisted digit decomposition (reference EvalFastRotationPrecompute,
    keyswitch-hybrid.cpp EvalKeySwitchPrecomputeCore): the ApproxModUp
    runs once per ciphertext and every rotation of it shares the digits."""
    return _decompose_digits(c1, tabs)


def eval_fast_rotation_core(digits: list, idx: torch.Tensor, ek: EvalKey,
                            tabs: HybridTables):
    """Key switch of a rotation on hoisted digits (reference
    EvalFastRotationExt + ApproxModDown): the automorphism with EVAL
    gather table `idx` permutes the extended digits, then the key's inner
    product and ApproxModDown. sigma_g commutes with the CRT lift only up
    to multiples of Q_j, so the words may differ from `keyswitch_core` of
    the rotated polynomial; both are valid key switches."""
    rot = [torch.index_select(d, -1, idx) for d in digits]
    return _mod_down_pair(*_fast_core_ext(rot, ek, tabs), tabs)


def raise_c0_ext(c0: torch.Tensor, p_modq, p_modq_sh,
                 tabs: HybridTables) -> torch.Tensor:
    """[c0]_{Q_l} -> [P*c0]_{Q_l*P} (reference KeySwitchExt): P*c0 is 0
    mod every P tower and (P mod q_i)*c0 on the Q towers."""
    size_ql = tabs.size_ql
    pc0 = mo.mul_mod_shoup(c0, p_modq[:size_ql], p_modq_sh[:size_ql],
                           tabs.basis_ql.q)
    zeros = c0.new_zeros((tabs.basis_p.k,) + tuple(c0.shape[1:]))
    return torch.cat([pc0, zeros], dim=0)


def eval_fast_rotation_core_ext(digits: list, idx: torch.Tensor, ek: EvalKey,
                                tabs: HybridTables):
    """A hoisted rotation without the ApproxModDown (reference
    EvalFastRotationExt): the (b, a) pair over Q_l*P, so that many
    rotations can be summed before one mod-down."""
    rot = [torch.index_select(d, -1, idx) for d in digits]
    return _fast_core_ext(rot, ek, tabs)


def mod_down_pair(ext0: torch.Tensor, ext1: torch.Tensor,
                  tabs: HybridTables):
    """ApproxModDown of both elements of an extended-basis pair back to
    Q_l (reference KeySwitchDown)."""
    return _mod_down_pair(ext0, ext1, tabs)


def mod_down_first(ext0: torch.Tensor, tabs: HybridTables) -> torch.Tensor:
    """ApproxModDown of element 0 alone (reference
    KeySwitchDownFirstElement)."""
    size_ql = tabs.size_ql
    return rt.approx_mod_down(ext0[:size_ql], ext0[size_ql:], tabs.basis_ql,
                              tabs.basis_p, tabs.moddown)
