"""BFV (RNS) scheme specifics.

Counterpart of `openfhe_tpu/pke/schemes/bfv.py` (reference analog:
bfvrns-leveledshe.cpp:217-410, ExpandCRTBasis -> tensor -> ScaleAndRound;
bfvrns-cryptoparameters.cpp, the tables; bfvrns-parametergeneration.cpp,
the sizing). The JAX package's integer-exact, float-free multiplication:

  1. expand the ciphertext from Q to the auxiliary basis R u {m_sk} by the
     approximate conversion (value c + uQ, u <= k_Q, absorbed as noise);
  2. tensor in both bases; per element v = t X + Q/2 (+ Q S on the
     auxiliary side, S = floor(R/2), which makes the quotient
     nonnegative); y + S = (v - [v]_Q) / Q over R u sk by one more
     approximate conversion;
  3. return from R to Q exactly by the Shenoy-Kumaresan correction: the
     m_sk residue pins the approximate conversion's overflow count.

On the card the transforms are kernels a/b and every conversion is
kernel k (`rns_tools.switch_crt_basis_approx`); the elementwise steps are
plain int64 torch, as the JAX package runs them in XLA. The port runs the
four elements' expansions, and the three products' scale-and-round, as
one batch each (the same words as one at a time). Relinearization and
rotations go through the hybrid key switch (noise scale 1).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from openfhe_tpu_torch.lattice import rns_tools as rt
from openfhe_tpu_torch.lattice.basis import make_basis
from openfhe_tpu_torch.lattice.dcrt import EVAL, Poly
from openfhe_tpu_torch.math import crt
from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.math import nbtheory
from openfhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from openfhe_tpu_torch.pke import parameters as prm
from openfhe_tpu_torch.pke.ciphertext import Ciphertext, Plaintext
from openfhe_tpu_torch.pke.constants import (MultipartyMode,
                                             MultiplicationTechnique,
                                             SecurityLevel)
from openfhe_tpu_torch.pke.encoding.packed import (coef_encode,
                                                   decode_packed,
                                                   encode_packed)
from openfhe_tpu_torch.pke.keys import KeyPair, PublicKey
from openfhe_tpu_torch.pke.schemes import rns_pke


def init_context(cc) -> None:
    p = cc.params
    t = p.plaintext_modulus
    if p.multiparty_mode == MultipartyMode.NOISE_FLOODING_MULTIPARTY:
        raise NotImplementedError(
            "NOISE_FLOODING_MULTIPARTY (its 128 extra bits) is not ported")
    if p.ring_dim == 0:
        # the smallest standardized N whose largest log QP covers the
        # chain at that N (the chain grows with log N)
        if p.security_level == SecurityLevel.HEStd_NotSet:
            p.ring_dim = 16384
        else:
            for cand in (1024, 2048, 4096, 8192, 16384, 32768):
                if (t - 1) % (2 * cand):
                    continue
                bpm = math.log2(t) + math.log2(cand) + 14
                lq = 34 + math.log2(t) + p.mult_depth * bpm
                kq = max(2, math.ceil(lq / p.scaling_mod_size))
                est = kq * p.scaling_mod_size
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
    # the noise-driven chain (reference bfvrns-parametergeneration.cpp)
    bits_per_mult = math.log2(t) + math.log2(n) + 14
    log_q = 34 + math.log2(t) + p.mult_depth * bits_per_mult
    k_q = max(2, math.ceil(log_q / p.scaling_mod_size))
    moduli = prm._distinct_prime_chain(2 * n, [p.scaling_mod_size] * k_q)
    cc._init_common(moduli)
    cc.L = 0                     # BFV is scale-invariant: no levels
    cc.noise_scale_int = 1
    cc.plaintext_modulus = t
    cc.slots = n
    cc.delta = 1.0
    _precompute_mult_tables(cc)


def _aux_size(cc, size_q: int) -> int:
    t = cc.plaintext_modulus
    n = cc.ring_dim
    log_ql = sum(math.log2(q) for q in cc.moduli_q[:size_q])
    log_r = (math.log2(t) + math.log2(n) + log_ql
             + 2 * math.log2(size_q + 2) + 4)
    return math.ceil(log_r / 30)


def _precompute_mult_tables(cc) -> None:
    t = cc.plaintext_modulus
    n = cc.ring_dim
    q_mods = cc.moduli_q
    cc.big_q = math.prod(q_mods)
    k_r = _aux_size(cc, len(q_mods))
    aux = prm._distinct_prime_chain(
        2 * n, [30] * (k_r + 1), forbidden=tuple(q_mods) + tuple(cc.moduli_p))
    cc.bfv_aux_pool, cc.bfv_m_sk = aux[:k_r], aux[k_r]
    cc._bfv_mt = {}
    _size_tables(cc, len(q_mods))
    # encryption's scaling Delta = floor(Q / t)
    delta = cc.big_q // t
    cc.c_delta_q = mo.shoup_pair([delta % q for q in q_mods], q_mods,
                                 cc.device)


@dataclasses.dataclass(frozen=True)
class MultTables:
    """The multiplication's tables for a Q basis of size_q towers (the
    reference's GetParamsQl / GetParamsRl leveled precomputations): bases,
    the two conversions and per-tower constants, each (value, Shoup
    companion) as [k, 1] columns."""
    basis_q: object
    basis_rsk: object
    basis_r: object
    basis_sk: object
    basis_qsk: object
    big_r: int
    st_q_to_rsk: rt.SwitchTables
    st_r_to_qsk: rt.SwitchTables
    c_t_q: tuple
    c_t_rsk: tuple
    c_halfq_q: tuple
    c_halfq_plus_qs_rsk: tuple
    c_qinv_rsk: tuple
    c_rinv_sk: tuple
    c_r_q: tuple
    c_s_q: tuple
    c_qlhat_q: tuple | None = None   # Q/Q_l mod q_i, a reduced basis only


def _size_tables(cc, size_q: int) -> MultTables:
    """The tables for a (possibly reduced) Q_l basis, cached per tower
    count: HPSPOVERQLEVELED tensors in the smallest basis the noise
    allows."""
    if size_q in cc._bfv_mt:
        return cc._bfv_mt[size_q]
    t = cc.plaintext_modulus
    n = cc.ring_dim
    dev = cc.device
    q_mods = list(cc.moduli_q[:size_q])
    big_q = math.prod(q_mods)
    k_r = min(_aux_size(cc, size_q), len(cc.bfv_aux_pool))
    r_mods = list(cc.bfv_aux_pool[:k_r])
    m_sk = cc.bfv_m_sk
    rsk_mods = r_mods + [m_sk]
    basis_q = cc.basis_q.slice(0, size_q)
    basis_rsk = make_basis(rsk_mods, n, device=dev)
    big_r = math.prod(r_mods)
    shift_s = big_r >> 1
    half_q = big_q >> 1
    pair = lambda vals, mods: mo.shoup_pair(vals, mods, dev)
    ql_hat = None
    if size_q < len(cc.moduli_q):
        # back to the full basis: times QlHat = Q / Q_l (the reference's
        # ExpandCRTBasisQlHat; dropped towers become zero)
        qh = math.prod(cc.moduli_q[size_q:])
        ql_hat = pair([qh % q for q in q_mods], q_mods)
    mt = MultTables(
        basis_q=basis_q, basis_rsk=basis_rsk,
        basis_r=basis_rsk.slice(0, k_r),
        basis_sk=basis_rsk.slice(k_r, k_r + 1),
        basis_qsk=basis_q.concat(basis_rsk.slice(k_r, k_r + 1)),
        big_r=big_r,
        st_q_to_rsk=rt.make_switch_tables(q_mods, rsk_mods, dev),
        st_r_to_qsk=rt.make_switch_tables(r_mods, q_mods + [m_sk], dev),
        c_t_q=pair([t % q for q in q_mods], q_mods),
        c_t_rsk=pair([t % r for r in rsk_mods], rsk_mods),
        c_halfq_q=pair([half_q % q for q in q_mods], q_mods),
        # the auxiliary side gets v + Q S (S makes the quotient
        # nonnegative)
        c_halfq_plus_qs_rsk=pair(
            [(half_q + big_q * shift_s) % r for r in rsk_mods], rsk_mods),
        c_qinv_rsk=pair([pow(big_q % r, -1, r) for r in rsk_mods], rsk_mods),
        c_rinv_sk=pair([pow(big_r % m_sk, -1, m_sk)], [m_sk]),
        c_r_q=pair([big_r % q for q in q_mods], q_mods),
        c_s_q=pair([shift_s % q for q in q_mods], q_mods),
        c_qlhat_q=ql_hat)
    cc._bfv_mt[size_q] = mt
    return mt


def _centered_residues(coeffs: np.ndarray, t: int, moduli) -> np.ndarray:
    centered = np.where(coeffs > t // 2, coeffs - t, coeffs)
    return crt.to_residues_host(centered, tuple(moduli))


def make_packed_plaintext(cc, values) -> Plaintext:
    t = cc.plaintext_modulus
    res = _centered_residues(encode_packed(values, t, cc.ring_dim), t,
                             cc.moduli_q)
    poly = ntt_fwd(mo.u32_tensor(res, cc.device), cc.basis_q)
    return Plaintext(poly=poly, fmt=1, level=0, noise_deg=1, scale=1.0,
                     slots=cc.ring_dim, encoding="PACKED",
                     values=np.asarray(values))


def scale_plaintext_for_add(cc, pt_poly: torch.Tensor) -> torch.Tensor:
    """Delta * m (the encryption's scaling; reference STANDARD)."""
    c, c_sh = cc.c_delta_q
    return mo.mul_mod_shoup(pt_poly, c, c_sh, cc.basis_q.q)


def encrypt_extended(cc, key, plaintext: Plaintext) -> Ciphertext:
    """EncryptionTechnique.EXTENDED (reference bfvrns-pke.cpp:53-150):
    encrypt over the extended basis Q r (r the first P tower, which the
    keys cover), the message times floor(Q r / t), then divide and round
    the fresh ciphertext by r: the fresh noise collapses to the
    modulus-switching noise."""
    t = cc.plaintext_modulus
    q_mods = tuple(int(q) for q in cc.moduli_q)
    if not cc.moduli_p:
        raise ValueError("EXTENDED encryption needs the auxiliary P chain")
    r = int(cc.moduli_p[0])
    qr_mods = q_mods + (r,)
    basis_qr = cc.basis_q.concat(cc.basis_p.slice(0, 1))
    if plaintext.encoding == "PACKED":
        coeffs = encode_packed(plaintext.values, t, cc.ring_dim)
    else:
        coeffs = coef_encode(plaintext.values, t, cc.ring_dim)
    m_qr = ntt_fwd(mo.u32_tensor(_centered_residues(coeffs, t, qr_mods),
                                 cc.device), basis_qr)
    delta_r = (math.prod(q_mods) * r) // t
    c, c_sh = mo.shoup_pair([delta_r % q for q in qr_mods], qr_mods,
                            cc.device)
    m_scaled = mo.mul_mod_shoup(m_qr, c, c_sh, basis_qr.q)
    if isinstance(key, KeyPair):
        key = key.public_key
    if isinstance(key, PublicKey):
        c0, c1 = rns_pke.encrypt_zero_pk(cc._gen, key, basis_qr,
                                         cc.params.secret_key_dist)
    else:
        c0, c1 = rns_pke.encrypt_zero_sk(cc._gen, key, basis_qr)
    c0 = mo.add_mod(c0, m_scaled, basis_qr.q)
    # divide and round by r back to Q (reference ScaleAndRoundPOverQ)
    tab = rt.make_drop_scale_tables(qr_mods, cc.device)
    c0, c1 = (rt.drop_last_and_scale(Poly(x, EVAL), basis_qr, tab).data
              for x in (c0, c1))
    return Ciphertext(elements=(c0, c1), level=plaintext.level,
                      noise_deg=plaintext.noise_deg, scale=plaintext.scale,
                      slots=plaintext.slots, key_tag=key.key_tag,
                      encoding=plaintext.encoding,
                      scale_int=plaintext.scale_int)


def _bfv_scale_round(x_q: torch.Tensor, x_rsk: torch.Tensor,
                     mt: MultTables) -> torch.Tensor:
    """round(t X / Q) mod Q from X's residues over Q and R u sk (all COEFF,
    [..., k, N])."""
    bq, brsk, bsk = mt.basis_q, mt.basis_rsk, mt.basis_sk
    k_r = mt.basis_r.k
    # v = t X + Q/2 (+ Q S on the auxiliary side)
    v_q = mo.add_mod(mo.mul_mod_shoup(x_q, *mt.c_t_q, bq.q),
                     mt.c_halfq_q[0], bq.q)
    v_rsk = mo.add_mod(mo.mul_mod_shoup(x_rsk, *mt.c_t_rsk, brsk.q),
                       mt.c_halfq_plus_qs_rsk[0], brsk.q)
    # y + S = (v - [v]_Q) / Q over R u sk (the conversion's slack: noise)
    conv = rt.switch_crt_basis_approx(v_q, bq, brsk, mt.st_q_to_rsk)
    y_rsk = mo.mul_mod_shoup(mo.sub_mod(v_rsk, conv, brsk.q),
                             *mt.c_qinv_rsk, brsk.q)
    y_r, y_sk = y_rsk[..., :k_r, :], y_rsk[..., k_r:, :]
    # Shenoy-Kumaresan: the exact return R -> Q
    z = rt.switch_crt_basis_approx(y_r.contiguous(), mt.basis_r,
                                   mt.basis_qsk, mt.st_r_to_qsk)
    z_q, z_sk = z[..., :-1, :], z[..., -1:, :]
    alpha = mo.mul_mod_shoup(mo.sub_mod(z_sk, y_sk, bsk.q), *mt.c_rinv_sk,
                             bsk.q)
    # alpha < k_R: a small integer, the same in every tower
    corr = mo.mul_mod_shoup(torch.remainder(alpha.long(), bq.q.long()),
                            *mt.c_r_q, bq.q)
    y_q = mo.sub_mod(z_q, corr, bq.q)
    # remove the S shift
    return mo.sub_mod(y_q, mt.c_s_q[0], bq.q)


def _bfv_tensor(a_elems, b_elems, mt: MultTables) -> tuple:
    """The full BFV tensor product: expand to R u sk, multiply,
    scale and round."""
    bq, brsk = mt.basis_q, mt.basis_rsk
    both = torch.stack(list(a_elems) + list(b_elems))       # [4, k, N]
    aux = ntt_fwd(rt.switch_crt_basis_approx(ntt_inv(both, bq), bq, brsk,
                                             mt.st_q_to_rsk), brsk)
    (a0, a1, b0, b1), (a0r, a1r, b0r, b1r) = both, aux
    prods_q = torch.stack([
        mo.mul_mod(a0, b0, bq.q),
        mo.add_mod(mo.mul_mod(a0, b1, bq.q), mo.mul_mod(a1, b0, bq.q), bq.q),
        mo.mul_mod(a1, b1, bq.q)])
    prods_r = torch.stack([
        mo.mul_mod(a0r, b0r, brsk.q),
        mo.add_mod(mo.mul_mod(a0r, b1r, brsk.q),
                   mo.mul_mod(a1r, b0r, brsk.q), brsk.q),
        mo.mul_mod(a1r, b1r, brsk.q)])
    y = _bfv_scale_round(ntt_inv(prods_q, bq), ntt_inv(prods_r, brsk), mt)
    return tuple(ntt_fwd(y, bq))


def _find_levels_to_drop(cc, mult_depth_done: int,
                         key_switch: bool = False) -> int:
    """The noise-driven tower-drop count of HPSPOVERQLEVELED (reference
    FindLevelsToDrop, bfvrns-leveledshe.cpp:96), hybrid key switch
    model."""
    p_t = float(cc.plaintext_modulus)
    n = cc.ring_dim
    dcrt_bits = cc.moduli_q[0].bit_length()
    sigma = 3.19
    alpha_assurance = 36.0
    b_err = sigma * math.sqrt(alpha_assurance)
    b_key = 1.0                                   # ternary secret
    num_part_q = cc.params.num_large_digits
    k_per_part = math.ceil(len(cc.moduli_q) / num_part_q)

    delta = 2.0 * math.sqrt(n)
    delta_ms = 4.0 * math.sqrt(n)
    v_norm = b_err * (1.0 + 2.0 * delta * b_key)

    def noise_ks():
        return k_per_part * (num_part_q * delta * b_err
                             + delta_ms * b_key + 1.0)

    c1 = delta * delta_ms * p_t * b_key
    c2 = delta * delta_ms * b_key * b_key / 2.0 + noise_ks()

    def logq_bfv():
        if mult_depth_done > 0:
            return (math.log2(4 * p_t)
                    + (mult_depth_done - 1) * math.log2(c1)
                    + math.log2(c1 * v_norm + mult_depth_done * c2))
        return math.log2(p_t * 4.0 * v_norm)

    logq = logq_bfv()
    loge = logq - 2 - math.log2(p_t)
    log_extra = math.log2(noise_ks()) if key_switch else math.log2(delta_ms)
    levels = math.floor(
        (loge - 3 * mult_depth_done - 16 - log_extra) / dcrt_bits)
    return max(0, min(levels, len(cc.moduli_q) - 1))


def _scale_to_ql(cc, poly_eval: torch.Tensor, size_l: int) -> torch.Tensor:
    """round(Q_l / Q c): exact tower drops one prime at a time with the
    CKKS rescale step (reference ScaleAndRound to GetParamsQl)."""
    size = poly_eval.shape[-2]
    out = poly_eval
    while size > size_l:
        out = rt.drop_last_and_scale(Poly(out, EVAL),
                                     cc.basis_q.slice(0, size),
                                     cc.rescale_tables(size)).data
        size -= 1
    return out


def _expand_ql_to_q(cc, poly_eval: torch.Tensor, size_l: int) -> torch.Tensor:
    """c -> c QlHat over the full basis (reference ExpandCRTBasisQlHat):
    kept towers times QlHat mod q_i, dropped towers zero."""
    c, c_sh = _size_tables(cc, size_l).c_qlhat_q
    scaled = mo.mul_mod_shoup(poly_eval, c, c_sh,
                              cc.basis_q.slice(0, size_l).q)
    pad = scaled.new_zeros(tuple(scaled.shape[:-2])
                           + (len(cc.moduli_q) - size_l, scaled.shape[-1]))
    return torch.cat([scaled, pad], dim=-2)


def eval_mult_no_relin(cc, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """The tensor product under the context's MultiplicationTechnique
    (reference EvalMultCore, bfvrns-leveledshe.cpp:199): BEHZ, HPS and
    HPSPOVERQ share the one exact path; HPSPOVERQLEVELED first drops the
    towers the noise has already consumed, tensors in the smaller basis
    and expands the result back to Q."""
    k_q = len(cc.moduli_q)
    size_l = k_q
    a_el, b_el = a.elements[:2], b.elements[:2]
    if (cc.params.multiplication_technique
            == MultiplicationTechnique.HPSPOVERQLEVELED):
        done = max(a.noise_deg, b.noise_deg) - 1
        size_l = max(2, k_q - _find_levels_to_drop(cc, done))
        if size_l < k_q:
            a_el = tuple(_scale_to_ql(cc, e, size_l) for e in a_el)
            b_el = tuple(_scale_to_ql(cc, e, size_l) for e in b_el)
    elems = _bfv_tensor(a_el, b_el, _size_tables(cc, size_l))
    if size_l < k_q:
        elems = tuple(_expand_ql_to_q(cc, e, size_l) for e in elems)
    return dataclasses.replace(a, elements=elems,
                               noise_deg=max(a.noise_deg, b.noise_deg) + 1)


def decrypt_tail(cc, coeff_residues: torch.Tensor,
                 ct: Ciphertext) -> Plaintext:
    """m = round(t [c(s)]_Q / Q) mod t, exact on the host, decoded."""
    t = cc.plaintext_modulus
    centered = crt.interpolate_centered(mo.to_u32(coeff_residues),
                                        tuple(cc.moduli_q))
    big_q = cc.big_q
    m = [(int(v) * t + (big_q >> 1)) // big_q % t for v in centered]
    vals = decode_packed(np.array(m, np.int64), t, cc.ring_dim)
    return Plaintext(poly=coeff_residues, fmt=0, level=0, slots=ct.slots,
                     encoding=ct.encoding, values=vals)
