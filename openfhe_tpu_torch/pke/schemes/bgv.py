"""BGV (RNS) scheme specifics.

Counterpart of `openfhe_tpu/pke/schemes/bgv.py` (reference analog:
bgvrns-leveledshe.cpp, mod reduction with the plaintext-modulus
correction, and bgvrns-parametergeneration.cpp, the noise-driven sizing).

Moduli are below 2^31, so one multiplicative level spans
`bgv_drops_per_level` towers (the reference sizes single 40-60 bit moduli
per level), and automatic rescaling drops that many towers at once. The
mod-reduce message factor q_l^{-1} mod t is tracked per ciphertext in
`scale_int` (reference m_scalingFactorInt) and divided out at decryption
and at plaintext encoding.

On the card, ModReduce is two NTT launches (kernels a, b) a dropped tower
around plain int64 torch; EvalMult and the key switches run the fused
chains with t in their tables.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from openfhe_tpu_torch.lattice import rns_tools as rt
from openfhe_tpu_torch.lattice.basis import Basis
from openfhe_tpu_torch.math import crt
from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.math import nbtheory
from openfhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from openfhe_tpu_torch.pke import parameters as prm
from openfhe_tpu_torch.pke.ciphertext import Ciphertext, Plaintext
from openfhe_tpu_torch.pke.constants import MultipartyMode, SecurityLevel
from openfhe_tpu_torch.pke.encoding.packed import decode_packed, encode_packed


def init_context(cc) -> None:
    p = cc.params
    t = p.plaintext_modulus
    if p.multiparty_mode == MultipartyMode.NOISE_FLOODING_MULTIPARTY:
        raise NotImplementedError(
            "NOISE_FLOODING_MULTIPARTY (its flooding towers) is not ported")
    if p.ring_dim == 0:
        # the smallest standardized N covering the chain at that N
        if p.security_level == SecurityLevel.HEStd_NotSet:
            p.ring_dim = 8192
        else:
            for cand in (1024, 2048, 4096, 8192, 16384, 32768):
                if (t - 1) % (2 * cand):
                    continue
                plb = math.log2(t) + math.log2(cand) + 16
                lvl = p.mult_depth * max(
                    1, math.ceil(plb / p.scaling_mod_size))
                est = p.first_mod_size + lvl * p.scaling_mod_size
                est += est / max(1, p.num_large_digits)   # + logP
                try:
                    prm.validate_security(p, cand, est)
                except ValueError:
                    continue
                p.ring_dim = cand
                break
            else:
                raise ValueError(
                    "no standardized ring dimension accommodates this "
                    "depth at the requested security level")
    n = p.ring_dim
    if (t - 1) % (2 * n) != 0 or not nbtheory.is_prime(t):
        raise ValueError(
            f"plaintext modulus {t} must be prime and = 1 mod 2N for packing")
    # towers per multiplicative level, from the noise of one product
    per_level_bits = math.log2(t) + math.log2(n) + 16
    drops = max(1, math.ceil(per_level_bits / p.scaling_mod_size))
    cc.bgv_drops_per_level = drops
    cc.L = p.mult_depth * drops
    cc.bgv_flood_towers = 0
    moduli = prm._distinct_prime_chain(
        2 * n, [p.first_mod_size] + [p.scaling_mod_size] * cc.L)
    cc._init_common(moduli)
    cc.noise_scale_int = t
    cc.plaintext_modulus = t
    cc.slots = n
    cc.delta = 1.0
    cc._bgv_drop_cache = {}


@dataclasses.dataclass(frozen=True)
class BGVDropTables:
    base: rt.DropScaleTables
    tinv_modql: torch.Tensor       # [t^{-1}]_{q_l}, [1, 1]
    tinv_modql_sh: torch.Tensor
    t_modqi: torch.Tensor          # [t]_{q_i} per remaining tower
    t_modqi_sh: torch.Tensor


def make_bgv_drop_tables(moduli, t: int, device="cpu") -> BGVDropTables:
    ql = moduli[-1]
    rest = moduli[:-1]
    a, a_sh = mo.shoup_pair([pow(t % ql, -1, ql)], [ql], device)
    b, b_sh = mo.shoup_pair([t % q for q in rest], rest, device)
    return BGVDropTables(base=rt.make_drop_scale_tables(moduli, device),
                         tinv_modql=a, tinv_modql_sh=a_sh,
                         t_modqi=b, t_modqi_sh=b_sh)


def drop_last_and_scale_bgv(x: torch.Tensor, basis: Basis,
                            tab: BGVDropTables) -> torch.Tensor:
    """The exact BGV mod reduce of one tower: c' = (c - delta) / q_l with
    delta = t [u t^{-1}]_{q_l} = u (mod q_l), 0 (mod t). EVAL in and
    out."""
    kq = x.shape[-2]
    sub_basis = basis.slice(0, kq - 1)
    last_basis = basis.slice(kq - 1, kq)
    u = ntt_inv(x[..., kq - 1:, :].contiguous(), last_basis)
    v = mo.mul_mod_shoup(u, tab.tinv_modql, tab.tinv_modql_sh,
                         last_basis.q)
    v_qi = torch.remainder(v.long(), sub_basis.q.long()).int()
    w = mo.mul_mod_shoup(v_qi, tab.t_modqi, tab.t_modqi_sh, sub_basis.q)
    w = ntt_fwd(w, sub_basis)
    diff = mo.sub_mod(x[..., :kq - 1, :], w, sub_basis.q)
    return mo.mul_mod_shoup(diff, tab.base.qlinv, tab.base.qlinv_sh,
                            sub_basis.q)


def mod_reduce(cc, ct: Ciphertext, levels: int | None = None) -> Ciphertext:
    """Drop `levels` towers (one multiplicative level by default), each
    an exact BGV drop, and track the message factor."""
    t = cc.plaintext_modulus
    levels = levels if levels is not None else cc.bgv_drops_per_level
    scale_int = ct.scale_int
    elems = tuple(ct.elements)
    for i in range(levels):
        size = cc.size_ql(ct.level + i)
        if size not in cc._bgv_drop_cache:
            cc._bgv_drop_cache[size] = make_bgv_drop_tables(
                tuple(cc.moduli_q[:size]), t, cc.device)
        basis = cc.basis_at(ct.level + i)
        elems = tuple(drop_last_and_scale_bgv(c, basis,
                                              cc._bgv_drop_cache[size])
                      for c in elems)
        ql = cc.moduli_q[size - 1]
        scale_int = (scale_int * pow(ql % t, -1, t)) % t
    return dataclasses.replace(ct, elements=elems, level=ct.level + levels,
                               noise_deg=max(1, ct.noise_deg - levels),
                               scale_int=scale_int)


def level_factor(cc, level: int) -> int:
    """The accumulated message factor prod(q_dropped^{-1}) mod t at
    `level`."""
    t = cc.plaintext_modulus
    f = 1
    for i in range(level):
        ql = cc.moduli_q[len(cc.moduli_q) - 1 - i]
        f = f * pow(ql % t, -1, t) % t
    return f


def make_packed_plaintext(cc, values, level: int = 0,
                          apply_factor: bool = True,
                          noise_deg: int = 1) -> Plaintext:
    """Integers into slots; with `apply_factor`, times the level's
    mod-reduce factor, so that additions at that level line up."""
    t = cc.plaintext_modulus
    coeffs = encode_packed(values, t, cc.ring_dim)
    f = level_factor(cc, level) if apply_factor else 1
    if f != 1:
        coeffs = coeffs * f % t
    centered = np.where(coeffs > t // 2, coeffs - t, coeffs)
    res = crt.to_residues_host(centered,
                               tuple(cc.moduli_q[:cc.size_ql(level)]))
    poly = ntt_fwd(mo.u32_tensor(res, cc.device), cc.basis_at(level))
    return Plaintext(poly=poly, fmt=1, level=level, noise_deg=noise_deg,
                     scale=1.0, slots=cc.ring_dim, encoding="PACKED",
                     values=np.asarray(values), scale_int=f)


def decrypt_tail(cc, coeff_residues: torch.Tensor,
                 ct: Ciphertext) -> Plaintext:
    """m = [c(s)]_Q mod t, the message factor divided out, decoded."""
    t = cc.plaintext_modulus
    size = cc.size_ql(ct.level)
    centered = crt.interpolate_centered(mo.to_u32(coeff_residues),
                                        tuple(cc.moduli_q[:size]))
    m = np.mod(centered.astype(object), t).astype(np.int64)
    m = m * pow(ct.scale_int % t, -1, t) % t
    vals = decode_packed(m, t, cc.ring_dim)
    return Plaintext(poly=coeff_residues, fmt=0, level=ct.level,
                     slots=ct.slots, encoding=ct.encoding, values=vals)
