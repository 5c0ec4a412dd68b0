"""Threshold / multiparty FHE (n-of-n additive, t-of-n sharing) and
interactive bootstrapping.

Counterpart of `openfhe_tpu/pke/multiparty.py` (reference analog:
base-multiparty.h :105-282, rns-multiparty.cpp and ckksrns-multiparty.cpp;
protocol notes in docs/static_docs/Threshold_FHE.md). As in the
reference's tests, parties run one after another in one process and hand
each other their objects.

Each random step is a draw from the context's generator and a
deterministic core that takes the draws (`*_core`), in the order the JAX
package samples them: a small signed [N] tensor for a ternary or Gaussian
sample, [k, N] EVAL residues for a uniform one. Every `EvalKey` the joint
key protocol returns carries its Shoup companions, so that a joint key
runs the fused key switch on the card (the JAX package returns them
without, and its TPU path then takes the unfused chain).

Interactive bootstrapping crosses the protocol boundary on the host:
`_extend_centered`, `_polynomial_round` and IntMPBootDecrypt's mask are
exact big-integer CRTs over the N coefficients (`math/crt.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openfhe_tpu_torch.lattice import rns_tools as rt
from openfhe_tpu_torch.lattice.dcrt import COEFF
from openfhe_tpu_torch.math import crt
from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.math import sampling
from openfhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from openfhe_tpu_torch.pke.ciphertext import Ciphertext, Plaintext
from openfhe_tpu_torch.pke.constants import MultipartyMode, Scheme
from openfhe_tpu_torch.pke.keys import EvalKey, KeyPair, PrivateKey, PublicKey
from openfhe_tpu_torch.pke.keyswitch.hybrid import (add_ps_old,
                                                    mul_const_int,
                                                    shoup_companions)
from openfhe_tpu_torch.pke.schemes import bfv, bgv, rns_pke

FLOODING_SIGMA_BITS = 17   # the smudging noise of partial decryptions


def _gaussians(cc, count: int) -> list:
    return [sampling.discrete_gaussian(cc._gen, (cc.ring_dim,))
            for _ in range(count)]


def _require_hybrid(cc, op: str) -> None:
    if cc.basis_p is None:
        raise ValueError(f"{op} needs HYBRID key switching (P towers), as "
                         "in the JAX package")


def _with_companions(cc, ek: EvalKey) -> EvalKey:
    return shoup_companions(ek, cc.basis_qp.moduli)


# ---------------------------------------------------------------------------
# keys and distributed decryption (base-multiparty.h :105-189)
# ---------------------------------------------------------------------------

def multiparty_key_gen(cc, prev_pk: PublicKey | None = None) -> KeyPair:
    """Round-robin joint keygen (base-multiparty.h:105): each party adds
    its share to the running public key, keeping the common `a`. The first
    party (no `prev_pk`) runs KeyGen. Either way the key counter moves
    once for the party's fresh secret first, as in the JAX package, so
    the tags are theirs: `key-2` for the first party of a new context,
    then `key-2+mp-key-3`."""
    cc._key_counter += 1
    tag = f"mp-key-{cc._key_counter}"
    if prev_pk is None:
        return cc.KeyGen()
    n = cc.ring_dim
    draws = (sampling.ternary(cc._gen, (n,)),
             sampling.discrete_gaussian(cc._gen, (n,)))
    return multiparty_key_gen_core(cc, prev_pk, tag, draws)


def multiparty_key_gen_core(cc, prev_pk: PublicKey, tag: str,
                            draws) -> KeyPair:
    """A later party's key share on given draws (s, e): b' = b + e - a s."""
    b = cc.basis_qp
    s_small, e_small = draws
    s_qp = rns_pke.small_eval(s_small, b)
    e = rns_pke.small_eval(e_small, b, cc.noise_scale_int)
    share = mo.sub_mod(e, mo.mul_mod(prev_pk.a, s_qp, b.q), b.q)
    joint = prev_pk.key_tag + "+" + tag
    return KeyPair(public_key=PublicKey(b=mo.add_mod(prev_pk.b, share, b.q),
                                        a=prev_pk.a, key_tag=joint),
                   secret_key=PrivateKey(s_qp=s_qp, key_tag=joint))


def _extra_limb(cc) -> bool:
    """NOISE_FLOODING_MULTIPARTY's extra-limb mask (BGV and BFV)."""
    return (cc.params.multiparty_mode
            == MultipartyMode.NOISE_FLOODING_MULTIPARTY
            and cc.scheme in (Scheme.BFVRNS_SCHEME, Scheme.BGVRNS_SCHEME))


def smudge_draw(cc, basis) -> torch.Tensor:
    """The smudging draw of a partial decryption over `basis`: under
    NOISE_FLOODING_MULTIPARTY for BGV and BFV a uniform element over
    Q' = Q / q_0 ([k - 1, N] EVAL), else a Gaussian [N] of sigma 2^17
    (NOISE_FLOODING_MULTIPARTY) or 3.19."""
    if _extra_limb(cc):
        if basis.k < 2:
            raise ValueError("extra-limb flooding needs >= 2 towers")
        return sampling.uniform_residues(cc._gen, basis.slice(1, basis.k))
    big = (cc.params.multiparty_mode
           == MultipartyMode.NOISE_FLOODING_MULTIPARTY)
    sigma = float(1 << FLOODING_SIGMA_BITS) if big else 3.19
    return sampling.discrete_gaussian(cc._gen, (cc.ring_dim,), sigma=sigma)


def smudge_core(cc, basis, draw: torch.Tensor) -> torch.Tensor:
    """The smudging noise in EVAL over `basis` from its draw
    (Threshold_FHE.md:28-40). The extra-limb mask b < Q' is switched
    exactly from Q' to Q in COEFF (`rt.switch_crt_basis_exact`, its tables
    cached per context in `cc._flood_cache`): |b| < Q / q_0 stays below
    Delta / 2 while it drowns the share's noise. BGV multiplies the mask
    or the Gaussian by t after the residue lift (t e passes int32 at sigma
    2^17), so it vanishes mod t."""
    ns = cc.noise_scale_int
    if _extra_limb(cc):
        sub = basis.slice(1, basis.k)
        key = (tuple(sub.moduli), tuple(basis.moduli))
        if key not in cc._flood_cache:
            cc._flood_cache[key] = rt.make_switch_tables(
                sub.moduli, basis.moduli, basis.device)
        x = rt.switch_crt_basis_exact(ntt_inv(draw, sub), sub, basis,
                                      cc._flood_cache[key])
    else:
        x = sampling.to_residues(draw, basis)
    if ns != 1:
        x = mul_const_int(x, ns, basis)
    return ntt_fwd(x, basis)


def multiparty_decrypt_lead(cc, ct: Ciphertext, sk: PrivateKey):
    """Lead partial decryption c0 + c1 s_1 + e_smudge
    (base-multiparty.h:189)."""
    basis = cc.basis_at(ct.level)
    return multiparty_decrypt_lead_core(cc, ct, sk, smudge_draw(cc, basis))


def multiparty_decrypt_lead_core(cc, ct: Ciphertext, sk: PrivateKey,
                                 draw: torch.Tensor) -> Ciphertext:
    basis = cc.basis_at(ct.level)
    part = mo.add_mod(ct.elements[0],
                      mo.mul_mod(ct.elements[1], sk.s_qp[:basis.k], basis.q),
                      basis.q)
    part = mo.add_mod(part, smudge_core(cc, basis, draw), basis.q)
    return dataclasses.replace(ct, elements=(part,))


def multiparty_decrypt_main(cc, ct: Ciphertext, sk: PrivateKey):
    """Another party's partial decryption c1 s_i + e_smudge."""
    basis = cc.basis_at(ct.level)
    return multiparty_decrypt_main_core(cc, ct, sk, smudge_draw(cc, basis))


def multiparty_decrypt_main_core(cc, ct: Ciphertext, sk: PrivateKey,
                                 draw: torch.Tensor) -> Ciphertext:
    basis = cc.basis_at(ct.level)
    part = mo.add_mod(mo.mul_mod(ct.elements[1], sk.s_qp[:basis.k], basis.q),
                      smudge_core(cc, basis, draw), basis.q)
    return dataclasses.replace(ct, elements=(part,))


def multiparty_decrypt_fusion(cc, partials, ct_meta: Ciphertext):
    """Sum the partial decryptions and decode (reference
    MultipartyDecryptFusion, cryptocontext.h:3151): CKKS by its decode,
    BGV and BFV by their decryption tails."""
    basis = cc.basis_at(ct_meta.level)
    acc = partials[0].elements[0]
    for p in partials[1:]:
        acc = mo.add_mod(acc, p.elements[0], basis.q)
    coeff = ntt_inv(acc, basis)
    if cc.scheme == Scheme.CKKSRNS_SCHEME:
        vals = cc.decode_ckks(mo.to_u32(coeff), ct_meta.level,
                              ct_meta.scale, ct_meta.slots)
        return Plaintext(poly=coeff, fmt=COEFF, level=ct_meta.level,
                         scale=ct_meta.scale, slots=ct_meta.slots,
                         values=vals)
    if cc.scheme == Scheme.BGVRNS_SCHEME:
        return bgv.decrypt_tail(cc, coeff, ct_meta)
    return bfv.decrypt_tail(cc, coeff, ct_meta)


def multi_add_pub_keys(cc, pk1: PublicKey, pk2: PublicKey,
                       key_tag: str = "") -> PublicKey:
    """Sum two public-key shares over a common `a` (reference
    MultiAddPubKeys, cryptocontext.h:3337)."""
    return PublicKey(b=mo.add_mod(pk1.b, pk2.b, cc.basis_qp.q), a=pk1.a,
                     key_tag=key_tag or pk1.key_tag)


# ---------------------------------------------------------------------------
# the joint evaluation-key protocol (base-multiparty.h :135-282)
# ---------------------------------------------------------------------------

def multi_key_switch_gen(cc, original_sk: PrivateKey, new_sk: PrivateKey,
                         ek_prev: EvalKey) -> EvalKey:
    """A key-switch key share on ek_prev's common `a` (reference
    MultiKeySwitchGen with ekPrev). One error draw per digit."""
    _require_hybrid(cc, "MultiKeySwitchGen")
    return multi_key_switch_gen_core(cc, original_sk, new_sk, ek_prev,
                                     _gaussians(cc, ek_prev.av.shape[0]))


def multi_key_switch_gen_core(cc, original_sk: PrivateKey,
                              new_sk: PrivateKey, ek_prev: EvalKey,
                              draws) -> EvalKey:
    """b_j = e_j - a_j s_new, plus P s_old on digit j's rows
    [alpha j, alpha (j + 1)) of Q, alpha = ceil(k_Q / digits)."""
    b = cc.basis_qp
    k_q = len(cc.moduli_q)
    num_parts = ek_prev.av.shape[0]
    alpha = -(-k_q // num_parts)
    ps_old = mo.mul_mod_shoup(original_sk.s_qp, cc.p_modq, cc.p_modq_sh,
                              b.q)
    bs = []
    for part, e_small in enumerate(draws):
        e = rns_pke.small_eval(e_small, b, cc.noise_scale_int)
        bb = mo.sub_mod(e, mo.mul_mod(ek_prev.av[part], new_sk.s_qp, b.q),
                        b.q)
        bs.append(add_ps_old(bb, ps_old, part, alpha, k_q, b))
    return _with_companions(cc, EvalKey(bv=torch.stack(bs), av=ek_prev.av,
                                        key_tag=new_sk.key_tag))


def multi_add_evalkeys(cc, ek1: EvalKey, ek2: EvalKey,
                       key_tag: str = "") -> EvalKey:
    """bv summed over the common av (reference MultiAddEvalKeys)."""
    return _with_companions(cc, EvalKey(
        bv=mo.add_mod(ek1.bv, ek2.bv, cc.basis_qp.q), av=ek1.av,
        key_tag=key_tag or ek1.key_tag))


def multi_mult_eval_key(cc, ek: EvalKey, sk: PrivateKey,
                        key_tag: str = "") -> EvalKey:
    """Both halves times the party's secret share, each row plus a fresh
    error (reference MultiMultEvalKey): an error per row of bv, then per
    row of av."""
    draws = _gaussians(cc, ek.bv.shape[0] + ek.av.shape[0])
    return multi_mult_eval_key_core(cc, ek, sk, draws, key_tag)


def multi_mult_eval_key_core(cc, ek: EvalKey, sk: PrivateKey, draws,
                             key_tag: str = "") -> EvalKey:
    b = cc.basis_qp
    rows = [*ek.bv, *ek.av]
    out = [mo.add_mod(mo.mul_mod(x, sk.s_qp, b.q),
                      rns_pke.small_eval(e, b, cc.noise_scale_int), b.q)
           for x, e in zip(rows, draws)]
    nb = ek.bv.shape[0]
    return _with_companions(cc, EvalKey(
        bv=torch.stack(out[:nb]), av=torch.stack(out[nb:]),
        key_tag=key_tag or ek.key_tag))


def multi_add_evalmult_keys(cc, ek1: EvalKey, ek2: EvalKey,
                            key_tag: str = "") -> EvalKey:
    """The joint relinearization key: both halves summed (reference
    MultiAddEvalMultKeys)."""
    q = cc.basis_qp.q
    return _with_companions(cc, EvalKey(
        bv=mo.add_mod(ek1.bv, ek2.bv, q), av=mo.add_mod(ek1.av, ek2.av, q),
        key_tag=key_tag or ek1.key_tag))


def _automorphed(cc, sk: PrivateKey, g: int) -> PrivateKey:
    return PrivateKey(s_qp=torch.index_select(sk.s_qp, -1, cc._auto_idx(g)),
                      key_tag=sk.key_tag)


def multi_eval_automorphism_keygen(cc, sk: PrivateKey, ek_prev_map: dict,
                                   g_list, key_tag: str = "") -> dict:
    """Joint rotation-key shares, s(X^g) -> s on each previous key's `a`
    (reference MultiEvalAutomorphismKeyGen)."""
    return {g: multi_key_switch_gen(cc, _automorphed(cc, sk, g), sk,
                                    ek_prev_map[g]) for g in g_list}


def multi_eval_automorphism_keygen_core(cc, sk: PrivateKey,
                                        ek_prev_map: dict, g_list,
                                        draws) -> dict:
    """The shares on given draws: one error per digit, g after g."""
    out, i = {}, 0
    for g in g_list:
        parts = ek_prev_map[g].av.shape[0]
        out[g] = multi_key_switch_gen_core(cc, _automorphed(cc, sk, g), sk,
                                           ek_prev_map[g],
                                           draws[i:i + parts])
        i += parts
    return out


def multi_add_automorphism_keys(cc, map1: dict, map2: dict,
                                key_tag: str = "") -> dict:
    return {g: multi_add_evalkeys(cc, map1[g], map2[g], key_tag)
            for g in map1}


# ---------------------------------------------------------------------------
# t-of-n secret sharing (reference ShareKeys / RecoverSharedKey: Shamir
# over each RNS modulus)
# ---------------------------------------------------------------------------

def share_keys(cc, sk: PrivateKey, num_parties: int, threshold: int,
               seed: int = 0) -> dict:
    """Shamir shares of the secret key per RNS tower, {party: [kQP, N]
    words}. The polynomial's coefficients come from numpy's
    `default_rng(seed)` and Horner runs in uint64 on the host, as in the
    JAX package, so the shares are its words."""
    s = mo.to_u32(sk.s_qp)                  # [kQP, N] EVAL residues
    k, n = s.shape
    rng = np.random.default_rng(seed)
    mods = np.array(cc.basis_qp.moduli, np.uint64)[:, None]
    coeffs = [s.astype(np.uint64)]
    for _ in range(threshold - 1):
        coeffs.append(rng.integers(0, 1 << 62, size=(k, n)).astype(np.uint64)
                      % mods)
    shares = {}
    # exact per modulus: values below 2^31, parties below 2^31
    for party in range(1, num_parties + 1):
        acc = np.zeros((k, n), np.uint64)
        for c in reversed(coeffs):
            acc = (acc * np.uint64(party) + c) % mods
        shares[party] = mo.u32_tensor(acc, sk.s_qp.device)
    return shares


def recover_shared_key(cc, shares: dict, key_tag: str = "") -> PrivateKey:
    """Lagrange interpolation at 0 per RNS tower."""
    parties = sorted(shares)
    mods = [int(m) for m in cc.basis_qp.moduli]
    acc = None
    for i in parties:
        lam = []
        for q in mods:
            num, den = 1, 1
            for j in parties:
                if j != i:
                    num = num * (-j) % q
                    den = den * (i - j) % q
            lam.append(num * pow(den, -1, q) % q)
        c, c_sh = mo.shoup_pair(lam, mods, cc.device)
        term = mo.mul_mod_shoup(shares[i], c, c_sh, cc.basis_qp.q)
        acc = term if acc is None else mo.add_mod(acc, term, cc.basis_qp.q)
    return PrivateKey(s_qp=acc, key_tag=key_tag or "recovered")


# ---------------------------------------------------------------------------
# interactive (two-round) bootstrapping, two parties and n (reference
# rns-multiparty.cpp IntBootDecrypt :374, IntBootEncrypt :406, IntBootAdd
# :484, PolynomialRound, ExtendBasis; ckksrns-multiparty.cpp
# IntBootAdjustScale :451, IntMPBoot* :116-448)
# ---------------------------------------------------------------------------

def _extend_centered(cc, poly_eval: torch.Tensor, from_size: int,
                     to_size: int) -> torch.Tensor:
    """Centred exact CRT extension from the first `from_size` towers of Q
    to the first `to_size` (reference ExtendBasis / ExpandCRTBasis): a
    host big-integer CRT at the protocol boundary."""
    b_from = cc.basis_q.slice(0, from_size)
    b_to = cc.basis_q.slice(0, to_size)
    centered = crt.interpolate_centered(
        mo.to_u32(ntt_inv(poly_eval, b_from)), b_from.moduli)
    res = crt.to_residues_host(centered, tuple(b_to.moduli))
    return ntt_fwd(mo.u32_tensor(res, cc.device), b_to)


def _polynomial_round(cc, cs_eval: torch.Tensor, size: int) -> torch.Tensor:
    """(reference PolynomialRound) Add Q/2 to the coefficients whose CRT
    value over the first `size` towers lies in (Q/4, 3Q/4]."""
    basis = cc.basis_q.slice(0, size)
    vals, big = crt.interpolate(mo.to_u32(ntt_inv(cs_eval, basis)),
                                basis.moduli)
    mid = (vals > big // 4) & (vals <= 3 * big // 4)
    shifted = np.where(mid, (vals + big // 2) % big, vals)
    res = crt.to_residues_host(shifted, tuple(basis.moduli))
    return ntt_fwd(mo.u32_tensor(res, cc.device), basis)


def int_boot_adjust_scale(cc, ct: Ciphertext) -> Ciphertext:
    """Compress to 2 towers on a canonical scale (IntBootAdjustScale):
    FLEXIBLE modes compress to 3, bring the scale to the scale of level
    k - 2 times q_2 by one scalar multiply, and ModReduce."""
    if cc._flexible():
        ct = cc.Compress(ct, 3)
        target = cc.scf_real[len(cc.moduli_q) - 2] * float(cc.moduli_q[2])
        ct = cc._scalar_mult_raw(ct, 1.0, target / ct.scale)
        return cc.ModReduce(ct)
    return cc.Compress(ct, 2)


def int_boot_decrypt(cc, sk: PrivateKey, ct: Ciphertext) -> Ciphertext:
    """Partial decryption share cs = c0 + c1 s (c0 s for a ciphertext of
    c1 alone), rounded (IntBootDecrypt)."""
    size = ct.num_towers
    basis = cc.basis_q.slice(0, size)
    s = sk.s_qp[:size]
    if len(ct.elements) == 1:
        cs = mo.mul_mod(ct.elements[0], s, basis.q)
    else:
        cs = mo.add_mod(mo.mul_mod(ct.elements[1], s, basis.q),
                        ct.elements[0], basis.q)
    return dataclasses.replace(ct, elements=(_polynomial_round(cc, cs,
                                                               size),))


def int_boot_encrypt(cc, pk: PublicKey, ct_share: Ciphertext) -> Ciphertext:
    """Re-encrypt a rounded share under the joint public key over the full
    modulus (IntBootEncrypt)."""
    draws = rns_pke.encrypt_zero_pk_draws(cc._gen, cc.ring_dim,
                                          cc.params.secret_key_dist)
    return int_boot_encrypt_core(cc, pk, ct_share, draws)


def int_boot_encrypt_core(cc, pk: PublicKey, ct_share: Ciphertext,
                          draws) -> Ciphertext:
    """IntBootEncrypt on the draws (u, e0, e1) of its encryption of zero
    (no noise scale: CKKS)."""
    ptxt = _extend_centered(cc, ct_share.elements[0], ct_share.num_towers,
                            len(cc.moduli_q))
    c0, c1 = rns_pke.encrypt_zero_pk_core(draws, pk, cc.basis_q)
    c0 = mo.add_mod(c0, ptxt, cc.basis_q.q)
    return dataclasses.replace(ct_share, elements=(c0, c1), level=0)


def int_boot_add(cc, ct1: Ciphertext, ct2_share: Ciphertext) -> Ciphertext:
    """Add the other party's extended share into c0 (IntBootAdd)."""
    k = ct1.num_towers
    ext = _extend_centered(cc, ct2_share.elements[0],
                           ct2_share.num_towers, k)
    c0 = mo.add_mod(ct1.elements[0], ext, cc.basis_q.slice(0, k).q)
    return dataclasses.replace(ct1, elements=(c0,) + ct1.elements[1:])


def _compression_towers(cc) -> int:
    """COMPACT keeps one compression tower, SLACK two."""
    lvl = cc.params.interactive_boot_compression_level
    return 1 if str(lvl).upper() == "COMPACT" else 2


def int_mp_boot_adjust_scale(cc, ct: Ciphertext) -> Ciphertext:
    """Compress to the message's and the compression's towers
    (IntMPBootAdjustScale)."""
    keep = (cc.params.scaling_mod_size // cc.moduli_q[0].bit_length() + 1
            + _compression_towers(cc))
    if cc._flexible():
        ct = cc.Compress(ct, keep + 1)
        target = (cc.scf_real[len(cc.moduli_q) - keep]
                  * float(cc.moduli_q[keep]))
        ct = cc._scalar_mult_raw(ct, 1.0, target / ct.scale)
        return cc.ModReduce(ct)
    return cc.Compress(ct, keep)


def int_mp_boot_random_element_gen(cc, pk: PublicKey) -> Ciphertext:
    """The common random polynomial over the full chain
    (IntMPBootRandomElementGen)."""
    return int_mp_boot_random_element_core(
        pk, sampling.uniform_residues(cc._gen, cc.basis_q))


def int_mp_boot_random_element_core(pk: PublicKey,
                                    crp: torch.Tensor) -> Ciphertext:
    return Ciphertext(elements=(crp,), level=0, key_tag=pk.key_tag)


def int_mp_boot_decrypt(cc, sk: PrivateKey, ct: Ciphertext,
                        a: Ciphertext) -> list:
    """A party's share pair (IntMPBootDecrypt); the draws are the mask M_i
    (uniform over the first compression towers), then e over the
    compressed chain and e' over the full one."""
    n = cc.ring_dim
    draws = (sampling.uniform_residues(
        cc._gen, cc.basis_q.slice(0, _compression_towers(cc))),
        sampling.discrete_gaussian(cc._gen, (n,)),
        sampling.discrete_gaussian(cc._gen, (n,)))
    return int_mp_boot_decrypt_core(cc, sk, ct, a, draws)


def int_mp_boot_decrypt_core(cc, sk: PrivateKey, ct: Ciphertext,
                             a: Ciphertext, draws) -> list:
    """h0_i = s_i c1 + e - M_i over the compressed chain and
    h1_i = -s_i a + e' + M_i over the full one, M_i centred and shared by
    both."""
    mask, e0_small, e1_small = draws
    c1 = ct.elements[1] if len(ct.elements) >= 2 else ct.elements[0]
    size = c1.shape[-2]
    k = len(cc.moduli_q)
    basis_c = cc.basis_q.slice(0, size)
    basis_q = cc.basis_q
    mask_basis = basis_q.slice(0, _compression_towers(cc))
    centered = crt.interpolate_centered(
        mo.to_u32(ntt_inv(mask, mask_basis)), mask_basis.moduli)
    on = lambda basis: ntt_fwd(mo.u32_tensor(crt.to_residues_host(
        centered, tuple(basis.moduli)), cc.device), basis)
    mi_c, mi_q = on(basis_c), on(basis_q)
    e0 = rns_pke.small_eval(e0_small, basis_c)
    e1 = rns_pke.small_eval(e1_small, basis_q)
    h0 = mo.sub_mod(mo.add_mod(mo.mul_mod(c1, sk.s_qp[:size], basis_c.q),
                               e0, basis_c.q), mi_c, basis_c.q)
    h1 = mo.add_mod(mo.sub_mod(e1, mo.mul_mod(a.elements[0], sk.s_qp[:k],
                                              basis_q.q), basis_q.q),
                    mi_q, basis_q.q)
    return [dataclasses.replace(ct, elements=(h0,)),
            dataclasses.replace(ct, elements=(h1,), level=0)]


def int_mp_boot_add(cc, shares_vec: list) -> list:
    """Sum the parties' share pairs (IntMPBootAdd)."""
    h0, h1 = shares_vec[0]
    q_c = cc.basis_q.slice(0, h0.num_towers).q
    e0, e1 = h0.elements[0], h1.elements[0]
    for p0, p1 in shares_vec[1:]:
        e0 = mo.add_mod(e0, p0.elements[0], q_c)
        e1 = mo.add_mod(e1, p1.elements[0], cc.basis_q.q)
    return [dataclasses.replace(h0, elements=(e0,)),
            dataclasses.replace(h1, elements=(e1,))]


def int_mp_boot_encrypt(cc, pk: PublicKey, shares: list, a: Ciphertext,
                        ct: Ciphertext) -> Ciphertext:
    """The refreshed ciphertext over the full modulus (IntMPBootEncrypt):
    (ext(c0 + h0) + h1, a)."""
    h0, h1 = shares
    size = ct.num_towers
    c0p = mo.add_mod(ct.elements[0], h0.elements[0],
                     cc.basis_q.slice(0, size).q)
    c0pp = mo.add_mod(_extend_centered(cc, c0p, size, len(cc.moduli_q)),
                      h1.elements[0], cc.basis_q.q)
    return dataclasses.replace(ct, elements=(c0pp, a.elements[0]), level=0,
                               key_tag=pk.key_tag)
