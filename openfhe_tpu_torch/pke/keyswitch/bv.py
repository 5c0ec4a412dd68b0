"""BV key switching (RNS digit decomposition, no auxiliary modulus).

Counterpart of `openfhe_tpu/pke/keyswitch/bv.py` (reference analog:
keyswitch-bv.cpp, KeySwitchBV). The ciphertext polynomial is decomposed
into its per-tower CRT components; the switch key holds, per tower i, an
encryption of s_old * [Q/q_i * (Q/q_i)^{-1}]_Q (the CRT unit mask) under
s_new. Key switching is the inner product of the extended components with
the key rows, with no ApproxModDown.

With `digit_size` w > 0 (the reference's relinWindow) each tower's
residue is split further into base-2^w digits, key rows (i, t) carrying
s_old * 2^(w t) * CRTunit_i; digits are below 2^w, so each extends to
every tower as it is (no conversion).

On the card each tower's extension is one conversion (kernel k,
`rns_tools.switch_crt_basis_approx` from the tower to the others) between
the NTTs (kernels a, b); the key product and the sums are plain torch, as
the JAX package runs them in XLA.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from openfhe_tpu_torch.lattice import rns_tools as rt
from openfhe_tpu_torch.lattice.basis import Basis
from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.math import sampling
from openfhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from openfhe_tpu_torch.pke.keys import EvalKey, PrivateKey
from openfhe_tpu_torch.pke.keyswitch import hybrid


@dataclasses.dataclass(frozen=True)
class BVPart:
    """Tower i's conversion to the other towers of Q_l."""
    switch: rt.SwitchTables
    digit_basis: Basis
    compl_basis: Basis
    idx: int


@dataclasses.dataclass(frozen=True)
class BVTables:
    parts: tuple                 # tuple[BVPart]
    basis_ql: Basis
    size_ql: int


def make_bv_tables(basis_q: Basis, size_ql: int) -> BVTables:
    mods = basis_q.moduli[:size_ql]
    parts = []
    for i in range(size_ql):
        parts.append(BVPart(
            switch=rt.make_switch_tables((mods[i],), mods[:i] + mods[i + 1:],
                                         basis_q.device),
            digit_basis=basis_q.slice(i, i + 1),
            compl_basis=(basis_q.slice(0, i)
                         .concat(basis_q.slice(i + 1, size_ql))),
            idx=i))
    return BVTables(parts=tuple(parts), basis_ql=basis_q.slice(0, size_ql),
                    size_ql=size_ql)


def _digit_count(basis_q: Basis, k_q: int, digit_size: int) -> int:
    max_bits = max(int(q).bit_length() for q in basis_q.moduli[:k_q])
    return int(math.ceil(max_bits / digit_size))


def keyswitch_gen(gen: torch.Generator, s_old: PrivateKey,
                  s_new: PrivateKey, basis_q: Basis, k_q: int,
                  ns_int: int = 1, digit_size: int = 0) -> EvalKey:
    """The switch key's rows (keyswitch-bv.cpp KeyGen).

    digit_size 0: a row per tower with message s_old * CRTunit_i (the pure
    RNS decomposition: noise ~ q_i, for degree-2 components only).
    digit_size w: rows (i, t) with message s_old * 2^(w t) * CRTunit_i
    (noise ~ 2^w)."""
    if digit_size == 0:
        # the hybrid generator with a digit per tower and P = 1
        p_modq, p_modq_sh = mo.shoup_pair([1] * k_q, basis_q.moduli[:k_q],
                                          basis_q.device)
        return hybrid.keyswitch_gen(gen, s_old, s_new, basis_q, k_q,
                                    num_parts=k_q, p_modq=p_modq,
                                    p_modq_sh=p_modq_sh, ns_int=ns_int)
    d_cnt = _digit_count(basis_q, k_q, digit_size)
    n = basis_q.ring_dim
    q = basis_q.q
    bs, as_ = [], []
    for i in range(k_q):
        for t in range(d_cnt):
            a = sampling.uniform_residues(gen, basis_q)
            e = ntt_fwd(sampling.to_residues(
                sampling.discrete_gaussian(gen, (n,)), basis_q), basis_q)
            if ns_int != 1:
                e = hybrid.mul_const_int(e, ns_int, basis_q)
            b = mo.sub_mod(e, mo.mul_mod(a, s_new.s_qp, q), q)
            fac = [(1 << (digit_size * t)) % m if j == i else 0
                   for j, m in enumerate(basis_q.moduli)]
            fc, fc_sh = mo.shoup_pair(fac, basis_q.moduli, basis_q.device)
            b = mo.add_mod(b, mo.mul_mod_shoup(s_old.s_qp, fc, fc_sh, q), q)
            bs.append(b)
            as_.append(a)
    return EvalKey(bv=torch.stack(bs), av=torch.stack(as_),
                   key_tag=s_new.key_tag)


def _acc(acc0, acc1, d, key_b, key_a, q):
    t0, t1 = mo.mul_mod(d, key_b, q), mo.mul_mod(d, key_a, q)
    if acc0 is None:
        return t0, t1
    return mo.add_mod(acc0, t0, q), mo.add_mod(acc1, t1, q)


def keyswitch_core_digits(c: torch.Tensor, ek: EvalKey, basis_ql: Basis,
                          digit_size: int, d_cnt_full: int):
    """The digit-decomposed BV switch: c's per-tower residues (COEFF) are
    split into base-2^w digits, each (tower, digit) row times its key.
    Returns (delta0, delta1) over Q_l in EVAL."""
    size_ql = c.shape[-2]
    c_coeff = ntt_inv(c, basis_ql)                         # [kql, N]
    mask = (1 << digit_size) - 1
    q = basis_ql.q
    acc0 = acc1 = None
    for i in range(size_ql):
        row = c_coeff[i]
        for t in range(d_cnt_full):
            d = (row >> (digit_size * t)) & mask             # [N]
            d_eval = ntt_fwd(d.expand(size_ql, -1).contiguous(), basis_ql)
            r = i * d_cnt_full + t
            acc0, acc1 = _acc(acc0, acc1, d_eval, ek.bv[r, :size_ql],
                              ek.av[r, :size_ql], q)
    return acc0, acc1


def keyswitch_core(c: torch.Tensor, ek: EvalKey, tabs: BVTables):
    """(delta0, delta1) over Q_l in EVAL for one polynomial in EVAL: tower
    i of c is extended to the others by one conversion and multiplies key
    row i."""
    q = tabs.basis_ql.q
    size_ql = tabs.size_ql
    acc0 = acc1 = None
    for pt in tabs.parts:
        own_eval = c[pt.idx:pt.idx + 1]
        if size_ql == 1:                   # no other tower to extend to
            acc0, acc1 = _acc(acc0, acc1, own_eval, ek.bv[0, :1],
                              ek.av[0, :1], q)
            continue
        own_coeff = ntt_inv(own_eval, pt.digit_basis)
        conv = rt.switch_crt_basis_approx(own_coeff, pt.digit_basis,
                                          pt.compl_basis, pt.switch)
        conv = ntt_fwd(conv, pt.compl_basis)
        digit = torch.cat([conv[:pt.idx], own_eval, conv[pt.idx:]], dim=0)
        acc0, acc1 = _acc(acc0, acc1, digit, ek.bv[pt.idx, :size_ql],
                          ek.av[pt.idx, :size_ql], q)
    return acc0, acc1
