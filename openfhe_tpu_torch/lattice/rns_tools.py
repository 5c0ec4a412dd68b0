"""RNS base-conversion tables (host) and the conversions built on them.

Counterpart of `openfhe_tpu/lattice/rns_tools.py` (reference analog:
DCRTPoly ApproxSwitchCRTBasis / ApproxModDown / DropLastElementAndScale,
dcrtpoly.h:231-313, and CryptoParametersRNS::PrecomputeCRTTables). A base
conversion is a small contraction over the tower axis,
out[j] = sum_i f(x[i]) * C[i, j] mod d_j, which `ops/modmatmul` runs.
"""

from __future__ import annotations

import dataclasses

import torch

from openfhe_tpu_torch.lattice.basis import Basis
from openfhe_tpu_torch.lattice.dcrt import EVAL, Poly
from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.ops.modmatmul import mod_matmul_rowmod
from openfhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv


@dataclasses.dataclass(frozen=True)
class SwitchTables:
    """Tables for the approximate CRT basis switch B -> D.

    bhat_inv[i]      = [(B/b_i)^{-1}]_{b_i}, [k_in, 1] (+ Shoup)
    bhat_mod_d[i, j] = [B/b_i]_{d_j}, [k_in, k_out] (+ Shoup)
    """
    bhat_inv: torch.Tensor
    bhat_inv_sh: torch.Tensor
    bhat_mod_d: torch.Tensor
    bhat_mod_d_sh: torch.Tensor


def make_switch_tables(from_moduli, to_moduli, device="cpu") -> SwitchTables:
    big_b = 1
    for b in from_moduli:
        big_b *= b
    bhat = [big_b // b for b in from_moduli]
    c, c_sh = mo.shoup_pair([pow(h % b, -1, b)
                             for h, b in zip(bhat, from_moduli)],
                            from_moduli, device)
    mat = [[h % d for d in to_moduli] for h in bhat]
    mat_sh = [[(v << 32) // d for v, d in zip(row, to_moduli)]
              for row in mat]
    return SwitchTables(bhat_inv=c, bhat_inv_sh=c_sh,
                        bhat_mod_d=mo.u32_tensor(mat, device),
                        bhat_mod_d_sh=mo.u32_tensor(mat_sh, device))


def switch_crt_basis_approx(x: torch.Tensor, in_basis: Basis,
                            out_basis: Basis,
                            tab: SwitchTables) -> torch.Tensor:
    """ApproxSwitchCRTBasis (dcrtpoly.h:231): out ~ x + u*B for small u >= 0.

    x: [..., k_in, N] COEFF residues in basis B; returns [..., k_out, N].
    """
    y = mo.mul_mod_shoup(x, tab.bhat_inv, tab.bhat_inv_sh, in_basis.q)
    return _accumulate_converted(y, tab, out_basis)


def _accumulate_converted(y: torch.Tensor, tab: SwitchTables,
                          out_basis: Basis) -> torch.Tensor:
    """sum_i y_i * [B/b_i]_{d_j} mod d_j: the base-conversion kernel."""
    return mod_matmul_rowmod(y, tab.bhat_mod_d, tab.bhat_mod_d_sh,
                             out_basis.q, out_basis.red64)


# ---------------------------------------------------------------------------
# ApproxModDown (hybrid key switching, reference dcrtpoly.h:249)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModDownTables:
    """P -> Q mod-down: switch tables for P->Q plus P^{-1} mod q_i."""
    switch: SwitchTables
    pinv_modq: torch.Tensor
    pinv_modq_sh: torch.Tensor


def make_mod_down_tables(p_moduli, q_moduli, device="cpu") -> ModDownTables:
    big_p = 1
    for p in p_moduli:
        big_p *= p
    c, c_sh = mo.shoup_pair([pow(big_p % q, -1, q) for q in q_moduli],
                            q_moduli, device)
    return ModDownTables(
        switch=make_switch_tables(p_moduli, q_moduli, device),
        pinv_modq=c, pinv_modq_sh=c_sh)


def approx_mod_down(x_q: torch.Tensor, x_p: torch.Tensor, q_basis: Basis,
                    p_basis: Basis, tab: ModDownTables,
                    fmt: int = EVAL) -> torch.Tensor:
    """(x - [x]_P) / P over Q: the hybrid-KS epilogue.

    x_q: [..., kq, N], x_p: [..., kp, N], both in `fmt`. Returns
    [..., kq, N] in `fmt`.
    """
    x_p_coeff = ntt_inv(x_p, p_basis) if fmt == EVAL else x_p
    conv = switch_crt_basis_approx(x_p_coeff, p_basis, q_basis, tab.switch)
    if fmt == EVAL:
        conv = ntt_fwd(conv, q_basis)
    diff = mo.sub_mod(x_q, conv, q_basis.q)
    return mo.mul_mod_shoup(diff, tab.pinv_modq, tab.pinv_modq_sh,
                            q_basis.q)


# ---------------------------------------------------------------------------
# DropLastElementAndScale: the CKKS rescale core
# (reference dcrtpoly-interface.h:816-848)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DropScaleTables:
    """For dropping tower l: q_l^{-1} mod q_i and floor(q_l/2) mod q_i
    (i < l), each with its Shoup companion."""
    qlinv: torch.Tensor
    qlinv_sh: torch.Tensor
    ql_half: int
    ql_half_modqi: torch.Tensor
    ql_half_modqi_sh: torch.Tensor


def make_drop_scale_tables(moduli, device="cpu") -> DropScaleTables:
    """Tables for dropping the last modulus of `moduli`."""
    ql = moduli[-1]
    rest = moduli[:-1]
    a, a_sh = mo.shoup_pair([pow(ql % q, -1, q) for q in rest], rest, device)
    h = ql >> 1
    c, c_sh = mo.shoup_pair([h % q for q in rest], rest, device)
    return DropScaleTables(qlinv=a, qlinv_sh=a_sh, ql_half=h,
                           ql_half_modqi=c, ql_half_modqi_sh=c_sh)


def drop_last_and_scale(x: Poly, basis: Basis, tab: DropScaleTables) -> Poly:
    """round(x / q_l) over Q_{l-1} per coefficient (CKKS rescale step).

    Works in EVAL: only the dropped tower round-trips through COEFF. Per
    coefficient c, round(c/ql) = (c + h - [c + h]_{ql}) / ql with
    h = floor(ql/2), so per remaining tower i we form
    w = ([u + h]_{ql} - h) mod q_i in COEFF (u = last tower), transform
    it, and compute (x_i - w) * ql^{-1} mod q_i.
    """
    kq = x.data.shape[-2]
    sub_basis = basis.slice(0, kq - 1)
    last_basis = basis.slice(kq - 1, kq)
    x_rest = x.data[..., :kq - 1, :]
    x_last = x.data[..., kq - 1:, :].contiguous()
    u = ntt_inv(x_last, last_basis) if x.fmt == EVAL else x_last
    u_shift = mo.add_mod(u, tab.ql_half, last_basis.q)
    w = torch.remainder(u_shift.long(), sub_basis.q.long())
    w = mo.sub_mod(w, tab.ql_half_modqi, sub_basis.q)
    if x.fmt == EVAL:
        w = ntt_fwd(w, sub_basis)
    diff = mo.sub_mod(x_rest, w, sub_basis.q)
    out = mo.mul_mod_shoup(diff, tab.qlinv, tab.qlinv_sh, sub_basis.q)
    return Poly(out, x.fmt)
