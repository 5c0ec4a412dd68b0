"""CKKS <-> FHEW scheme switching.

Counterpart of `openfhe_tpu/pke/schemeswitch.py` (reference analog:
ckksrns-schemeswitching.cpp: EvalCKKStoFHEWSetup :728 / KeyGen :789 /
Precompute :838 / EvalCKKStoFHEW :887, ExtractLWEpacked :306,
EvalFHEWtoCKKS :1035, EvalSchemeSwitchingSetup :1180,
EvalCompareSchemeSwitching :1359, EvalMinSchemeSwitching :1402).

The design is the JAX package's, word for word:
  * CKKS -> FHEW: the homomorphic decode (SlotsToCoeffs as a BSGS linear
    transform on hoisted rotations), LevelReduce to the last tower q0, the
    exact rounding q0 -> Q' (a one-tower ring at the CKKS ring dimension),
    a hybrid key switch over Q' and one auxiliary tower P to the RLWE
    embedding of the LWE secret, the negacyclic extraction of every LWE
    sample at once and the rounding to q_LWE;
  * FHEW -> CKKS: the partial decryption B - A s as a rectangular linear
    transform against a CKKS encryption of the replicated LWE secret, then
    the sine-based reduction (the bootstrap's double-angle Chebyshev seed,
    three iterations) and the post-scale;
  * comparison, min and max through the inner BinFHE context's EvalSign.

The host steps of the JAX package (the exact q0 -> Q' switch, the
extraction, the rounding) are int64 torch on the context's device here.
Two things differ from the JAX package without changing a word: the
per-call diagonals of EvalFHEWtoCKKS (n_po2 = 2048 of them at STD128) are
made one at a time and encoded without entering the context's plaintext
cache, where the JAX package keeps every call's encodings for the
context's life; and a precompute that replaces the S2C diagonals drops
their cached encodings. The Q' key switch is one Q' tower and one P tower;
it runs the unfused chain (`hybrid.keyswitch_core` on tables without the
fused ones: kernels a, b and k on the card), as the JAX package runs it.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from openfhe_tpu_torch.binfhe import lwe as lwe_mod
from openfhe_tpu_torch.binfhe.context import BinFHEContext
from openfhe_tpu_torch.lattice.basis import make_basis
from openfhe_tpu_torch.math import crt, nbtheory
from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from openfhe_tpu_torch.pke.ciphertext import Ciphertext
from openfhe_tpu_torch.pke.fhe.ckks_bootstrap import (_mod_func_coefficients,
                                                      apply_double_angle,
                                                      drop_cached,
                                                      eval_linear_transform)
from openfhe_tpu_torch.pke.keys import PrivateKey
from openfhe_tpu_torch.pke.keyswitch import hybrid


@dataclass
class SchSwchParams:
    """(reference SchSwchParams, scheme-switching setup knobs)"""
    security_level_fhew: str = "TOY"          # TOY or STD128
    num_slots_ckks: int = 0
    num_values: int = 0
    ctxt_mod_size_fhew_large_prec: int = 25   # log q_LWE (large precision)
    ctxt_mod_size_fhew_intermed_swch: int = 27  # log Q' (intermediate)
    arbitrary_function_evaluation: bool = False
    bstep_lt: int = 0


@dataclass
class SchemeSwitchState:
    params: SchSwchParams
    cc_lwe: BinFHEContext = None
    lwe_sk: object = None
    n_lwe: int = 0
    q_prime: int = 0                 # intermediate modulus Q'
    modulus_lwe: int = 0             # q_LWE
    basis_int: object = None         # 1-tower basis at Q' (ring dim N)
    swk: object = None               # CKKS -> RLWE(LWE key) switch key
    swk_tabs: object = None
    s2c_diags: list = field(default_factory=list)
    s2c_bstep: int = 0
    s2c_pt_slots: int = 0
    slots: int = 0
    # FHEW -> CKKS
    fhew_to_ckks_swk: object = None  # CKKS encryption of the LWE secret
    k_bound: float = 128.0
    cheb_fhew: list = field(default_factory=list)


def _decode_matrices(slots: int):
    m = 4 * slots
    omega = np.exp(2j * np.pi / m)
    rot_group = np.array([pow(5, i, m) for i in range(slots)])
    u0 = omega ** (np.outer(rot_group, np.arange(slots)) % m)
    return u0, 1j * u0


def eval_ckks_to_fhew_setup(cc, params: SchSwchParams):
    """(reference EvalCKKStoFHEWSetup :728) The FHEW context (on the CKKS
    context's device) and the intermediate 1-tower modulus Q'; returns the
    LWE secret key."""
    st = SchemeSwitchState(params=params)
    st.slots = params.num_slots_ckks or cc.ring_dim // 2
    st.cc_lwe = BinFHEContext(seed=101, device=cc.device)
    n_fhew, ring_fhew = ((32, 1024) if params.security_level_fhew == "TOY"
                         else (1305, 2048))
    q_fhew = ring_fhew if params.arbitrary_function_evaluation \
        else 2 * ring_fhew
    # baseG = 128 gives 4 gadget digits at a 27-bit Q (the reference pairs
    # 2^18 with a 54-bit Q'; 31-bit towers cap Q at 27 bits here)
    st.cc_lwe.GenerateBinFHEContextCustom(
        n=n_fhew, N=ring_fhew, q=q_fhew, q_bits=27, base_ks=32, base_g=128)
    # the large-precision modulus of the switched LWE ciphertexts
    st.modulus_lwe = (1 << params.ctxt_mod_size_fhew_large_prec) \
        if not params.arbitrary_function_evaluation else st.cc_lwe.q
    st.n_lwe = st.cc_lwe.n
    # intermediate modulus Q' (same ring dim as the CKKS context)
    st.q_prime = nbtheory.previous_prime(
        1 << params.ctxt_mod_size_fhew_intermed_swch, 2 * cc.ring_dim)
    if st.q_prime in cc.moduli_q:
        st.q_prime = nbtheory.previous_prime(st.q_prime, 2 * cc.ring_dim)
    st.basis_int = make_basis([st.q_prime], cc.ring_dim, device=cc.device)
    st.lwe_sk = st.cc_lwe.KeyGen()
    cc._schswch = st
    return st.lwe_sk


def _secret_coeff_signed(cc, sk: PrivateKey) -> torch.Tensor:
    """The small signed secret from its tower-0 EVAL residues, int64 [N]."""
    s0 = ntt_inv(sk.s_qp[:1], cc.basis_q.slice(0, 1))[0].long()
    q0 = cc.moduli_q[0]
    return torch.where(s0 > q0 // 2, s0 - q0, s0)


def aux_modulus(cc, q_prime: int) -> int:
    """The auxiliary P of the Q' key switch: the first prime = 1 mod 2N
    below 2^30 that is neither Q' nor a CKKS tower."""
    p_aux = nbtheory.previous_prime(1 << 30, 2 * cc.ring_dim)
    while p_aux == q_prime or p_aux in cc.moduli_q:
        p_aux = nbtheory.previous_prime(p_aux, 2 * cc.ring_dim)
    return p_aux


def switch_tables(st: SchemeSwitchState, p_aux: int):
    """The Q' key switch's tables: one digit, one P tower, unfused."""
    basis_p = make_basis([p_aux], st.basis_int.ring_dim,
                         device=st.basis_int.device)
    return dataclasses.replace(
        hybrid.make_hybrid_tables(st.basis_int, basis_p, 1, 1), fused=None)


def eval_ckks_to_fhew_keygen(cc, keys, lwe_sk):
    """(reference EvalCKKStoFHEWKeyGen :789): hybrid switch key from the
    CKKS secret to the RLWE embedding of the LWE secret, both in the
    intermediate 1-tower ring; plus S2C rotation keys."""
    st = cc._schswch
    n_ring = cc.ring_dim
    sk = keys.secret_key
    p_aux = aux_modulus(cc, st.q_prime)
    basis_qp = st.basis_int.concat(make_basis([p_aux], n_ring,
                                              device=cc.device))
    s_from = _secret_coeff_signed(cc, sk).cpu().numpy()
    s_lwe = np.zeros(n_ring, np.int64)
    s_lwe[:st.n_lwe] = lwe_sk.s.cpu().numpy().astype(np.int64)

    def embed(v):
        res = crt.to_residues_host(v, tuple(basis_qp.moduli))
        return ntt_fwd(mo.u32_tensor(res, cc.device), basis_qp)

    sk_from = PrivateKey(s_qp=embed(s_from), key_tag=sk.key_tag)
    sk_to = PrivateKey(s_qp=embed(s_lwe), key_tag="lwe-rlwe")
    p_modq, p_modq_sh = mo.shoup_pair([p_aux % st.q_prime, 0],
                                      basis_qp.moduli, cc.device)
    st.swk = hybrid.keyswitch_gen(cc._gen, sk_from, sk_to, basis_qp, 1, 1,
                                  p_modq, p_modq_sh)
    st.swk_tabs = switch_tables(st, p_aux)

    # S2C rotation keys (the bootstrap's BSGS ladder)
    slots = st.slots
    bstep = st.params.bstep_lt or max(1, int(math.ceil(math.sqrt(slots))))
    st.s2c_bstep = bstep
    gstep = int(math.ceil(slots / bstep))
    rots = sorted({r for r in (
        list(range(1, bstep)) + [bstep * j for j in range(1, gstep)]
        + [slots]) if r})
    cc.EvalRotateKeyGen(sk, rots)
    cc.EvalConjugateKeyGen(sk)
    if sk.key_tag not in cc.eval_mult_keys:
        cc.EvalMultKeyGen(sk)


def eval_ckks_to_fhew_precompute(cc, scale: float = 1.0):
    """(reference EvalCKKStoFHEWPrecompute :838): S2C matrix diagonals with
    the scale that turns CKKS values into Q'/p_LWE-scaled LWE phases. The
    encodings of the diagonals it replaces leave the context's cache."""
    st = cc._schswch
    slots = st.slots
    sparse = slots < cc.ring_dim // 2
    u0, u1 = _decode_matrices(slots)
    bstep = st.s2c_bstep
    # after S2C the coefficients are value * gamma * sigma_out, and the
    # switch q0 -> Q' multiplies by Q'/q0: gamma = scale * q0 / sigma_out
    # gives m * Q' * scale (scale usually 1/p_LWE)
    q0 = cc.moduli_q[0]
    sigma_out = cc.scf_real[len(cc.moduli_q) - 1]
    gamma = scale * q0 / sigma_out
    if sparse:
        mat = np.concatenate([u0, u1], axis=1)            # [s, 2s]
        rows = 2 * slots
        diags = []
        for d in range(slots):
            idx = np.arange(rows)
            diag = mat[idx % slots, (idx + d) % (2 * slots)] * gamma
            diags.append(np.roll(diag, bstep * (d // bstep)))
        pt_slots = 2 * slots
    else:
        diags = []
        for d in range(slots):
            idx = np.arange(slots)
            diag = u0[idx % slots, (idx + d) % slots] * gamma
            diags.append(np.roll(diag, bstep * (d // bstep)))
        pt_slots = slots
    drop_cached(cc, st.s2c_diags)
    st.s2c_diags, st.s2c_pt_slots = diags, pt_slots


def _round_to(x: torch.Tensor, q_from: int, q_to: int) -> torch.Tensor:
    """round(x * q_to / q_from) mod q_to for int64 x, negatives included
    (floor division, as numpy's)."""
    return torch.remainder(
        torch.div(x * q_to * 2 + q_from, 2 * q_from, rounding_mode="floor"),
        q_to)


def eval_ckks_to_fhew(cc, ct: Ciphertext, num_ctxts: int = 0):
    """(reference EvalCKKStoFHEW :887): S2C -> drop to q0 -> switch to Q'
    -> key switch to the LWE key -> extract LWE samples -> round to q."""
    st = cc._schswch
    slots = st.slots
    num_ctxts = num_ctxts or slots
    n_ring = cc.ring_dim

    # 1. homomorphic decode
    ct_dec = eval_linear_transform(cc, ct, st.s2c_diags, st.s2c_bstep,
                                   st.s2c_pt_slots)
    ct_dec = cc.ModReduce(ct_dec)
    if st.s2c_pt_slots == 2 * slots:     # sparse: fold the two halves
        ct_dec = cc.EvalAdd(ct_dec, cc.EvalRotate(ct_dec, slots))

    # 2. drop to the last tower (q0)
    size = cc.size_ql(ct_dec.level)
    if size > 1:
        ct_dec = cc.LevelReduce(ct_dec, size - 1)
    basis1 = cc.basis_at(ct_dec.level)
    q0 = cc.moduli_q[0]

    # 3. the exact switch q0 -> Q' of the centred coefficients
    qp = st.q_prime
    switched = []
    for e in ct_dec.elements[:2]:
        x = ntt_inv(e, basis1)[0].long()
        x = torch.where(x > q0 // 2, x - q0, x)
        switched.append(ntt_fwd(_round_to(x, q0, qp)[None].int(),
                                st.basis_int))

    # 4. key switch to the RLWE-embedded LWE key
    d0, d1 = hybrid.keyswitch_core(switched[1], st.swk, st.swk_tabs)
    b_poly = ntt_inv(mo.add_mod(switched[0], d0, st.basis_int.q),
                     st.basis_int)[0].long()
    a_poly = ntt_inv(d1, st.basis_int)[0].long()

    # 5. the LWE samples of coefficients 0, gap, 2 gap, ... (negacyclic)
    n = st.n_lwe
    gap = n_ring // (2 * slots)
    dev = cc.device
    idxs = (torch.arange(num_ctxts, device=dev) * gap)[:, None]   # [B, 1]
    pos = idxs - torch.arange(n, device=dev)[None, :]             # [B, n]
    a = torch.where(pos < 0, a_poly[torch.remainder(pos, n_ring)],
                    torch.remainder(qp - a_poly[torch.remainder(pos, n_ring)],
                                    qp))
    b = b_poly[idxs[:, 0]]

    # 6. round to the FHEW modulus
    qlwe = st.modulus_lwe
    if qlwe != qp:
        a, b = _round_to(a, qp, qlwe), _round_to(b, qp, qlwe)
    return lwe_mod.LWECiphertext(a=a.int(), b=b.int(), modulus=int(qlwe),
                                 pt_modulus=4)


# ---------------------------------------------------------------------------
# FHEW -> CKKS
# ---------------------------------------------------------------------------

def eval_fhew_to_ckks_keygen(cc, keys, lwe_sk):
    """(reference EvalFHEWtoCKKSKeyGen :959): the LWE secret encrypted
    under CKKS, replicated to fill the slots, and the transform's rotation
    keys."""
    st = cc._schswch
    n = st.n_lwe
    n_po2 = 1 << int(math.ceil(math.log2(n)))
    s = np.zeros(n_po2)
    s[:n] = lwe_sk.s.cpu().numpy().astype(np.float64)
    reps = (cc.ring_dim // 2) // n_po2
    pt = cc.MakeCKKSPackedPlaintext(np.tile(s, max(1, reps)),
                                    slots=cc.ring_dim // 2)
    st.fhew_to_ckks_swk = cc.Encrypt(keys.public_key, pt)
    st.k_bound = 16.0 if n == 32 else 128.0
    st.cheb_fhew = _mod_func_coefficients(st.k_bound, 3)
    # the BSGS ladder over n_po2 diagonals, the sparse fold and the powers
    # of two of the tournament's masks
    bstep = max(1, int(math.ceil(math.sqrt(n_po2))))
    gstep = int(math.ceil(n_po2 / bstep))
    pow2s = [1 << t for t in range(16) if (1 << t) <= st.slots]
    rots = sorted({r for r in (
        list(range(1, bstep)) + [bstep * j for j in range(1, gstep)]
        + [st.slots * (1 << t) for t in range(16)
           if st.slots * (1 << t) < cc.ring_dim // 2]
        + pow2s + [-r for r in pow2s]) if r})
    cc.EvalRotateKeyGen(keys.secret_key, rots)


class _Diagonals:
    """The partial decryption's diagonals, each made when it is asked for
    (the JAX package builds all n_po2 at once: 512 MB of float64 at
    N=2^16): diagonal d of the [num_values, n_po2] matrix over N/2 slots,
    pre-rotated for BSGS, word for word the JAX package's arrays."""

    def __init__(self, amat: np.ndarray, half: int, bstep: int):
        self.amat, self.half, self.bstep = amat, half, bstep

    def __len__(self) -> int:
        return self.amat.shape[1]

    def __getitem__(self, d: int) -> np.ndarray:
        num_values, n_po2 = self.amat.shape
        rows = np.arange(self.half)
        diag = self.amat[rows % num_values, (rows + d) % n_po2]
        return np.roll(diag, self.bstep * (d // self.bstep))


def eval_fhew_to_ckks(cc, lwe_cts, num_ctxts: int = 0, num_slots: int = 0,
                      p: int = 4, pmin: float = 0.0, pmax: float = 2.0):
    """(reference EvalFHEWtoCKKS :1035): homomorphic partial decryption
    B - A*s followed by a sine-based modular reduction. The diagonals are
    encoded as they are used and not kept."""
    st = cc._schswch
    slots = num_slots or st.slots
    a_host = mo.to_u32(lwe_cts.a).astype(np.float64)          # [B, n]
    b_host = mo.to_u32(lwe_cts.b).astype(np.float64)
    num_values = num_ctxts or a_host.shape[0]
    n = a_host.shape[1]
    n_po2 = 1 << int(math.ceil(math.log2(n)))
    q_lwe = float(lwe_cts.modulus)
    prescale = (1.0 / q_lwe) / st.k_bound

    # rectangular LT: out_i = sum_j A[i, j] * s_j against the replicated
    # secret; diagonals of length N/2, the row pattern repeating
    half = cc.ring_dim // 2
    amat = np.zeros((num_values, n_po2))
    amat[:, :n] = a_host[:num_values] * prescale
    bstep = max(1, int(math.ceil(math.sqrt(n_po2))))
    a_dot_s = eval_linear_transform(cc, st.fhew_to_ckks_swk,
                                    _Diagonals(amat, half, bstep), bstep,
                                    half, cache=False)
    a_dot_s = cc.ModReduce(a_dot_s)

    # B - A*s, prescaled into the Chebyshev range
    bvec = np.zeros(half)
    bvec[:num_values] = b_host[:num_values] * prescale
    b_pt = cc.MakeCKKSPackedPlaintext(bvec, level=a_dot_s.level,
                                      slots=half)
    diff = cc.EvalAdd(cc.EvalNegate(a_dot_s), b_pt)

    # sine-based modular reduction (double-angle seed, 3 iterations)
    y = cc.EvalChebyshevSeries(diff, st.cheb_fhew, -1.0, 1.0)
    if y.noise_deg > 1:
        y = cc.ModReduce(y)
    y = apply_double_angle(cc, y, 3)

    # post-scale to the CKKS encoding of the message
    post_scale = 2.0 * math.pi if 1 <= p <= 4 else float(p)
    post_bias = 0.0
    if pmin != 0:
        post_scale *= (pmax - pmin) / 4.0
        post_bias = (pmax - pmin) / 4.0
    mask = np.zeros(half)
    mask[:num_values] = post_scale
    y = cc.EvalMult(y, cc.MakeCKKSPackedPlaintext(mask, level=y.level,
                                                  slots=half))
    y = cc.ModReduce(y)
    if post_bias != 0:
        bias = np.zeros(half)
        bias[:num_values] = post_bias
        y = cc.EvalAdd(y, cc.MakeCKKSPackedPlaintext(bias, level=y.level,
                                                     slots=half))

    # back to sparse packing if asked: each folded copy carries the
    # message once; the first `num_values` slots are meaningful
    if slots < half:
        j = slots
        while j < half:
            y = cc.EvalAdd(y, cc.EvalRotate(y, j))
            j <<= 1
        y = dataclasses.replace(y, slots=slots)
    return y


# ---------------------------------------------------------------------------
# comparison / min / max via FHEW sign
# ---------------------------------------------------------------------------

def _min_max_tournament(cc, ct, public_key, num_values: int,
                        num_slots: int = 0, p_lwe: int = 0,
                        scale_sign: float = 1.0,
                        compute_max: bool = False):
    """Tournament min/max with the argmin one-hot indicator (reference
    EvalMinSchemeSwitching :1402 / EvalMaxSchemeSwitching)."""
    st = cc._schswch
    if p_lwe:
        eval_ckks_to_fhew_precompute(cc, scale_sign / p_lwe)
    slots = num_slots or st.slots
    c_ind = cc.Encrypt(public_key, cc.MakeCKKSPackedPlaintext(
        np.ones(num_values), slots=slots))
    new_ct = ct
    m_step = 1
    while m_step < num_values:
        nh = num_values // (2 * m_step)
        c_diff = cc.EvalSub(new_ct, cc.EvalRotate(new_ct, nh))
        lwe_ct = eval_ckks_to_fhew(cc, c_diff, nh)
        signs = st.cc_lwe.EvalSign(lwe_ct, scheme_switch=True)
        sel = eval_fhew_to_ckks(cc, signs, nh, slots, 4, -1.0, 1.0)
        # ones on the first nh slots only, so the complement never leaks
        # into the wrapped region (reference ptxtOnes of length n)
        ones = np.zeros(slots)
        ones[:nh] = 1.0
        ones_pt = cc.MakeCKKSPackedPlaintext(ones, level=sel.level,
                                             slots=slots)
        if compute_max:
            sel = cc.EvalAdd(cc.EvalNegate(sel), ones_pt)
        # combined mask: sel on [0, nh), (1 - sel) shifted onto [nh, 2nh)
        compl = cc.EvalAdd(cc.EvalNegate(sel), ones_pt)
        mask = cc.EvalAdd(sel, cc.EvalRotate(compl, -nh))
        if m_step > 1:
            j = num_values // m_step
            while j < num_values:
                mask = cc.EvalAdd(mask, cc.EvalRotate(mask, -j))
                j <<= 1
        new_ct = cc.EvalMult(new_ct, mask)
        new_ct = cc.EvalAdd(new_ct, cc.EvalRotate(new_ct, nh))
        c_ind = cc.EvalMult(c_ind, mask)
        m_step <<= 1
    return new_ct, c_ind


def eval_min_scheme_switching(cc, ct, public_key, num_values: int,
                              num_slots: int = 0, p_lwe: int = 0,
                              scale_sign: float = 1.0):
    return _min_max_tournament(cc, ct, public_key, num_values, num_slots,
                               p_lwe, scale_sign, compute_max=False)


def eval_max_scheme_switching(cc, ct, public_key, num_values: int,
                              num_slots: int = 0, p_lwe: int = 0,
                              scale_sign: float = 1.0):
    return _min_max_tournament(cc, ct, public_key, num_values, num_slots,
                               p_lwe, scale_sign, compute_max=True)


def eval_compare_switch_precompute(cc, p_lwe: int = 0,
                                   scale_sign: float = 1.0):
    """(reference EvalCompareSwitchPrecompute :1345)"""
    st = cc._schswch
    if p_lwe == 0:
        p_lwe = st.modulus_lwe // (2 * st.cc_lwe.beta)
    scale = 1.0 / (p_lwe * scale_sign) if p_lwe else scale_sign
    eval_ckks_to_fhew_precompute(cc, scale)


def eval_compare_scheme_switching(cc, ct1, ct2, num_ctxts: int = 0,
                                  num_slots: int = 0):
    """sign(ct1 - ct2) through FHEW EvalSign (reference
    EvalCompareSchemeSwitching :1368): a CKKS ciphertext holding 1 where
    ct1 < ct2 and 0 elsewhere."""
    st = cc._schswch
    diff = cc.EvalSub(ct1, ct2)
    lwe_cts = eval_ckks_to_fhew(cc, diff, num_ctxts)
    signs = st.cc_lwe.EvalSign(lwe_cts, scheme_switch=True)
    # EvalSign returns +-q/4 phases mod q; repack through FHEW -> CKKS
    return eval_fhew_to_ckks(cc, signs, num_ctxts, num_slots, 4, -1.0, 1.0)
