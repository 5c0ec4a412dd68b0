"""CKKS bootstrapping: ModRaise -> CoeffsToSlots -> EvalMod -> SlotsToCoeffs.

Counterpart of `openfhe_tpu/pke/fhe/ckks_bootstrap.py` (reference analog:
ckksrns-fhe.cpp EvalBootstrapSetup :85-259, EvalBootstrapKeyGen :264,
EvalBootstrap :429-837, AdjustCiphertext :2228, ApplyDoubleAngleIterations,
EvalLinearTransform; the matrices U0[i][j] = omega^{j*5^i}, omega =
exp(2*pi*i/(4*slots)), ckksrns-fhe.cpp:169-259).

The design is the JAX package's, word for word:
  * scale bookkeeping rides on the exact float64 per-ciphertext scale: a
    correction scale-down before ModRaise for sine accuracy and integer
    multiplies (boost1, boost2) at the end for noise headroom, with the
    residual value factor folded into the SlotsToCoeffs matrix at setup;
  * the Chebyshev coefficients of the double-angle seed
        f(y) = (2pi)^(-1/2^R) * cos(2*pi*(K*y)/2^R - pi/2^(R+1))
    are interpolated at setup with numpy to adaptive degree; R double-angle
    iterations then give sin(2*pi*K*y)/(2*pi);
  * the ModRaise clamp |I| <= K is sized from the ring (K ~ 7 sqrt(N/18)
    for uniform ternary secrets, the Hamming weight for sparse ones).

The setup is host numpy; each side of a test builds its own tables. On the
card every step runs kernels the port already has: the NTTs (a, b) and
the base conversion (k) in ModRaise, the fused key switches for EvalMult,
EvalSquare, EvalRotate and EvalConjugate, and the unfused hoisted path for
EvalFastRotation. The rest is plain int64 torch, as the JAX package runs it
in XLA.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from openfhe_tpu_torch.lattice import rns_tools as rt
from openfhe_tpu_torch.math import crt
from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from openfhe_tpu_torch.pke.ciphertext import Ciphertext
from openfhe_tpu_torch.pke.constants import SecretKeyDist
from openfhe_tpu_torch.pke.fhe import fft_transform as fftt


# ---------------------------------------------------------------------------
# setup: precomputed tables
# ---------------------------------------------------------------------------

@dataclass
class CKKSBootstrapPrecom:
    """Per-slot-count bootstrap precompute (reference CKKSBootstrapPrecom)."""
    slots: int
    k_bound: float                 # K: clamp on the mod-raise overflow count
    r_iters: int                   # double-angle iteration count
    cheb_coeffs: list              # Chebyshev coeffs (c0 doubled)
    correction: int                # log2 of the pre-ModRaise scale-down
    # BSGS diagonals: numpy complex arrays, pre-rotated for BSGS
    c2s_diags: list = field(default_factory=list)
    s2c_diags: list = field(default_factory=list)
    bstep_enc: int = 0
    bstep_dec: int = 0
    pt_slots: int = 0              # slot count the LT plaintexts encode at
    sparse: bool = False
    runtime_scalar: float = 1.0    # folded scalar applied right after raise
    boost1: int = 1                # integer headroom multiplier after EvalMod
    boost2: int = 1                # integer headroom multiplier after S2C
    # FFT-factorized C2S/S2C (level budget > 1): fft_transform.FFTStage
    # lists in application order; None selects the dense transform
    c2s_stages: list | None = None
    s2c_stages: list | None = None
    exp_coeffs: list | None = None  # EvalFBTSetup's exponential seed


def _adaptive_k(n: int, secret_dist) -> int:
    """Clamp bound K on |I| in ct = m + q0*I after the raise: a 7-sigma
    bound on a coefficient of c0 + c1*s. Uniform ternary: sigma ~
    sqrt(N/18), which gives the reference's K_UNIFORM = 512 class at
    N = 2^16. SPARSE_TERNARY (Hamming weight 192): sigma ~
    sqrt((h+1)/12), the reference's K_SPARSE = 28 class
    (ckksrns-fhe.h:418)."""
    if secret_dist == SecretKeyDist.SPARSE_TERNARY:
        h = 192
        return max(16, math.ceil(7.0 * math.sqrt((h + 1) / 12.0)))
    sigma = math.sqrt(n / 18.0)
    return max(16, math.ceil(7.0 * sigma))


def _mod_func_coefficients(k_bound: float, r_iters: int) -> list:
    """Chebyshev coefficients (on [-1,1]) of the double-angle seed
    function; after r steps ct <- 2*ct^2 - (2pi)^(-2^i) the series value
    becomes sin(2*pi*K*y)/(2*pi)."""
    two_pi = 2.0 * math.pi
    pow2r = float(1 << r_iters)
    amp = two_pi ** (-1.0 / pow2r)

    def f(y):
        return amp * np.cos(two_pi * (k_bound * y) / pow2r
                            - math.pi / (2.0 * pow2r))

    return _interpolate(f)


def _interpolate(f) -> list:
    """Chebyshev interpolant of f on [-1, 1], the degree doubled from 16
    until the last four coefficients fall below 1e-13, the negligible tail
    trimmed, c0 doubled (EvalChebyshevSeries halves c0)."""
    deg = 16
    while deg < 4096:
        c = np.polynomial.chebyshev.Chebyshev.interpolate(f, deg)
        if np.abs(c.coef[-4:]).max() < 1e-13:
            break
        deg *= 2
    coeffs = list(c.coef)
    while len(coeffs) > 8 and abs(coeffs[-1]) < 1e-14:
        coeffs.pop()
    coeffs[0] *= 2.0
    return coeffs


def _bsgs_diagonals(mat_rows: np.ndarray, n_diags: int, bstep: int,
                    scale: float) -> list:
    """Generalized diagonals of a (rows x cols) matrix, diag_d[i] =
    M[i mod rows][(i + d) mod cols], each right-rotated by
    bstep*(d // bstep) so the giant-step rotation applies to the inner sum
    (reference EvalLinearTransformPrecompute)."""
    rows, cols = mat_rows.shape
    diags = []
    for d in range(n_diags):
        idx_i = np.arange(rows)
        diag = mat_rows[idx_i % rows, (idx_i + d) % cols] * scale
        diags.append(np.roll(diag, bstep * (d // bstep)))
    return diags


def get_bootstrap_depth(level_budget=(1, 1), secret_key_dist=None,
                        n: int = 1 << 16) -> int:
    """Multiplicative depth the bootstrap consumes (reference
    FHECKKSRNS::GetBootstrapDepth, ckksrns-fhe.cpp:2199): the correction
    adjust (1), the post-raise normalization (1), lEnc, the conjugate
    reduce (1), the Chebyshev Paterson-Stockmeyer depth, the double-angle
    iterations and lDec."""
    k = _adaptive_k(n, secret_key_dist)
    r_iters = 6 if k > 64 else 4
    deg = len(_mod_func_coefficients(k, r_iters)) - 1
    cheb_depth = int(math.ceil(math.log2(max(2, deg)))) + 2
    return 2 + int(level_budget[0]) + 1 + cheb_depth + r_iters \
        + int(level_budget[1])


def eval_bootstrap_setup(cc, level_budget=(1, 1), dim1=(0, 0), slots: int = 0,
                         correction_factor: int = 0) -> None:
    """(reference EvalBootstrapSetup, ckksrns-fhe.cpp:85) level_budget =
    (lEnc, lDec): 1 selects the dense one-level linear transform, > 1 the
    FFT-factorized staged transform of lEnc / lDec levels."""
    n = cc.ring_dim
    slots = slots or n // 2
    if slots & (slots - 1):
        raise ValueError("bootstrap slots must be a power of two")
    sparse = slots < n // 2

    k_bound = _adaptive_k(n, cc.params.secret_key_dist)
    r_iters = 6 if k_bound > 64 else 4
    if correction_factor == 0:
        # balances the sine-linearization error (4^-c) against the noise
        # headroom the scale-down costs (2^c)
        correction_factor = 4
    cheb = _mod_func_coefficients(k_bound, r_iters)

    # --- linear-transform matrices (ckksrns-fhe.cpp:169-259) ---
    m = 4 * slots
    omega = np.exp(2j * np.pi / m)
    rot_group = np.array([pow(5, i, m) for i in range(slots)])
    j_idx = np.arange(slots)
    u0 = omega ** (np.outer(rot_group, j_idx) % m)       # [slots, slots]
    u0h = u0.conj().T
    u1 = 1j * u0
    u1h = u1.conj().T

    bstep_enc = max(1, int(math.ceil(math.sqrt(slots))))
    bstep_dec = bstep_enc

    # Scale bookkeeping, all setup-time constants:
    #   sigma1   : scale of the adjusted ciphertext entering ModRaise
    #   enc_scale: 1/K folded into the C2S matrix
    #   runtime  : sigma1/(N*q0), so slots before EvalMod hold z_k/(K*q0)
    #   dec_scale: undoes the residual value factor (reference scaleDec)
    if not cc._flexible():
        raise ValueError("CKKS bootstrapping requires FLEXIBLEAUTO scaling "
                         "(28-bit moduli make FIXED-mode drift fatal)")
    d = cc.comp_deg
    n_levels = len(cc.scf_real)
    q0 = math.prod(cc.moduli_q[:d])   # composite: the first level's product
    sigma1 = cc.scf_real[n_levels - 1]
    correction = correction_factor
    boost1 = max(1, int(round(float(q0) / sigma1)))
    if boost1 > 4:
        warnings.warn(
            f"bootstrap SNR: first-level modulus q0 is {boost1}x the "
            f"scaling factor; the EvalMod signal m/q0 shrinks by that "
            f"factor while the transform noise floor does not, costing "
            f"~log2({boost1}) = {math.log2(boost1):.0f} precision bits "
            f"(boost1 re-amplifies the message only AFTER the noise is "
            f"mixed in). Size first_mod_size <= scaling_mod_size + 2 "
            f"(reference: 60-bit q0 vs 59-bit scale, ckksrns-fhe.cpp).",
            stacklevel=3)
    boost2 = 1 << correction
    v_factor = math.pow(2.0, -correction) * sigma1 / float(q0) \
        * boost1 * boost2
    enc_scale = 1.0 / k_bound
    dec_scale = 1.0 / v_factor

    log2s = max(1, int(math.log2(slots)))
    l_enc = max(1, min(int(level_budget[0]), log2s))
    l_dec = max(1, min(int(level_budget[1]), log2s))

    # The staged transforms compose to U0 * P_bitrev (slots in bit-reversed
    # order, which the staged inverse consumes); the dense diagonals are
    # the natural-order U0. A mixed budget therefore builds its budget-1
    # side as a one-stage staged transform, in the staged convention.
    mixed = (l_enc == 1) != (l_dec == 1)

    c2s, s2c = [], []
    c2s_stages = s2c_stages = None
    pt_slots = 2 * slots if sparse else slots
    if l_enc > 1 or mixed:
        c2s_stages, _ = fftt.build_c2s_stages(slots, n, l_enc, dim1[0],
                                              enc_scale)
    elif sparse:
        # vertical [U0^H; U1^H]: (2s x s); s diagonals of length 2s
        mat_c2s = np.concatenate([u0h, u1h], axis=0)      # [2s, s]
        c2s = _bsgs_diagonals(mat_c2s, slots, bstep_enc, enc_scale)
    else:
        c2s = _bsgs_diagonals(u0h, slots, bstep_enc, enc_scale)

    if l_dec > 1 or mixed:
        s2c_stages, _ = fftt.build_s2c_stages(slots, n, l_dec, dim1[1],
                                              dec_scale)
    elif sparse:
        # horizontal [U0 | U1]: (s x 2s); s diagonals of length 2s read
        # through a (2s x 2s) wrap of the row index
        mat_s2c = np.concatenate([u0, u1], axis=1)        # [s, 2s]
        rows = 2 * slots
        for d in range(slots):
            idx = np.arange(rows)
            diag = mat_s2c[idx % slots, (idx + d) % (2 * slots)] * dec_scale
            s2c.append(np.roll(diag, bstep_dec * (d // bstep_dec)))
    else:
        s2c = _bsgs_diagonals(u0, slots, bstep_dec, dec_scale)

    if slots in cc._boot_precom:
        _drop_encodings(cc, cc._boot_precom[slots])
    cc._boot_precom[slots] = CKKSBootstrapPrecom(
        slots=slots, k_bound=float(k_bound), r_iters=r_iters,
        cheb_coeffs=cheb, correction=correction,
        c2s_diags=c2s, s2c_diags=s2c, bstep_enc=bstep_enc,
        bstep_dec=bstep_dec, pt_slots=pt_slots, sparse=sparse,
        runtime_scalar=sigma1 / (float(n) * float(q0)),
        boost1=boost1, boost2=boost2,
        c2s_stages=c2s_stages, s2c_stages=s2c_stages)


def _drop_encodings(cc, p: CKKSBootstrapPrecom) -> None:
    """Forget the context's cached encodings of a precompute's diagonals
    (a Setup that replaces it); the JAX package keeps them for the
    context's life."""
    arrays = list(p.c2s_diags) + list(p.s2c_diags)
    for stages in (p.c2s_stages or [], p.s2c_stages or []):
        arrays += [d for st in stages for d in st.diags.values()]
    mine = {id(a): a for a in arrays}
    for key in [k for k, (values, _) in cc._pt_cache.items()
                if mine.get(k[0]) is values]:
        del cc._pt_cache[key]


def bootstrap_rotation_indices(cc, slots: int) -> list:
    """Every rotation index EvalBootstrap uses for `slots`."""
    p = cc._boot_precom[slots]
    n = cc.ring_dim
    idx = set()
    for stages, b in ((p.c2s_stages, p.bstep_enc),
                      (p.s2c_stages, p.bstep_dec)):
        if stages is not None:
            idx.update(fftt.stage_rotation_indices(stages))
        else:
            g = int(math.ceil(slots / b))
            idx.update(range(1, b))
            idx.update(b * j for j in range(1, g))
    if p.sparse:
        j = slots
        while j < n // 2:
            idx.add(j)
            j <<= 1
        idx.add(slots)
    idx.discard(0)
    return sorted(idx)


def eval_bootstrap_keygen(cc, sk, slots: int = 0) -> None:
    """(reference EvalBootstrapKeyGen, ckksrns-fhe.cpp:264)"""
    slots = slots or cc.ring_dim // 2
    cc.EvalRotateKeyGen(sk, bootstrap_rotation_indices(cc, slots))
    cc.EvalConjugateKeyGen(sk)
    if cc.eval_mult_keys.get(sk.key_tag) is None:
        cc.EvalMultKeyGen(sk)


# ---------------------------------------------------------------------------
# primitive ops of the pipeline
# ---------------------------------------------------------------------------

def _modraise_tables(cc, d: int):
    """The composite raise's tables, cached on the context: the switch
    from the first d towers to the whole chain and B/2 mod each tower."""
    group = tuple(cc.moduli_q[:d])
    all_mods = tuple(cc.moduli_q)
    key = ("modraise", group, all_mods)
    if key not in cc._modraise_cache:
        half = math.prod(group) // 2
        dev = cc.device
        cc._modraise_cache[key] = (
            rt.make_switch_tables(group, all_mods, dev),
            mo.shoup_pair([half % b for b in group], group, dev)[0],
            mo.shoup_pair([half % q for q in all_mods], all_mods, dev)[0])
    return cc._modraise_cache[key]


def mod_raise(cc, ct: Ciphertext) -> Ciphertext:
    """Raise a last-level ciphertext to the full chain: residues mod q0
    are centred to (-q0/2, q0/2] and reduced mod every q_i (reference
    ckksrns-fhe.cpp:592-600). One-word q0: ntt_inv, the centred lift,
    ntt_fwd. Composite q0 (reference ExtendCiphertext,
    ckksrns-fhe.cpp:2290): shift by B/2, the exact CRT switch of
    `rns_tools.switch_crt_basis_exact`, unshift."""
    d = cc.comp_deg
    size = cc.size_ql(ct.level)
    if size != d:
        ct = cc.LevelReduce(ct, (size - d) // d)
    full = cc.basis_q

    if d == 1:
        basis1 = cc.basis_at(ct.level).slice(0, 1)
        q0 = cc.moduli_q[0]
        half = q0 >> 1
        q0_mod_qi = mo.shoup_pair([q0 % q for q in cc.moduli_q],
                                  cc.moduli_q, cc.device)[0]

        def raise_one(elem):
            u = ntt_inv(elem[..., :1, :].contiguous(), basis1)
            r = torch.remainder(u.long(), full.q.long()).int()
            r = torch.where(u > half, mo.sub_mod(r, q0_mod_qi, full.q), r)
            return ntt_fwd(r, full)
    else:
        basis_d = cc.basis_q.slice(0, d)
        sw_tab, hin, hout = _modraise_tables(cc, d)

        def raise_one(elem):
            u = ntt_inv(elem[..., :d, :].contiguous(), basis_d)
            u = mo.add_mod(u, hin, basis_d.q)
            v = rt.switch_crt_basis_exact(u, basis_d, full, sw_tab)
            v = mo.sub_mod(v, hout, full.q)
            return ntt_fwd(v, full)

    return dataclasses.replace(
        ct, elements=tuple(raise_one(c) for c in ct.elements), level=0)


def mult_by_monomial(cc, ct: Ciphertext, power: int) -> Ciphertext:
    """ct * X^power (reference MultByMonomialInPlace): an EVAL multiply by
    the monomial's transform; no scale change."""
    n = cc.ring_dim
    power = power % (2 * n)
    sign = 1
    if power >= n:
        power -= n
        sign = -1
    coeffs = np.zeros(n, np.int64)
    coeffs[power] = sign
    size = cc.size_ql(ct.level)
    basis = cc.basis_at(ct.level)
    res = crt.to_residues_host(coeffs, tuple(cc.moduli_q[:size]))
    mono = ntt_fwd(mo.u32_tensor(res, cc.device), basis)
    return dataclasses.replace(ct, elements=tuple(
        mo.mul_mod(c, mono, basis.q) for c in ct.elements))


def mult_by_integer(cc, ct: Ciphertext, value: int) -> Ciphertext:
    """ct * integer without scale change (reference MultByIntegerInPlace)."""
    size = cc.size_ql(ct.level)
    mods = cc.moduli_q[:size]
    c, c_sh = mo.shoup_pair([value % q for q in mods], mods, cc.device)
    q = cc.basis_at(ct.level).q
    return dataclasses.replace(ct, elements=tuple(
        mo.mul_mod_shoup(e, c, c_sh, q) for e in ct.elements))


def eval_linear_transform(cc, ct: Ciphertext, diags: list, bstep: int,
                          pt_slots: int) -> Ciphertext:
    """BSGS diagonal-method linear transform (reference
    EvalLinearTransform): out = sum_j rot_{b*j}(sum_i diag'_{b*j+i} *
    rot_i(ct)), the diagonals pre-rotated by -b*j at setup, the baby-step
    rotations hoisted over one digit decomposition of c1."""
    n_diags = len(diags)
    gstep = int(math.ceil(n_diags / bstep))
    rots = {0: ct}
    hoisted = cc.EvalFastRotationPrecompute(ct)
    for i in range(1, min(bstep, n_diags)):
        rots[i] = cc.EvalFastRotation(ct, i, digits=hoisted)
    outer = None
    for j in range(gstep):
        inner = None
        for i in range(bstep):
            d = bstep * j + i
            if d >= n_diags:
                break
            pt = cc._cached_plaintext(diags[d], ct.level, pt_slots)
            term = cc._eval_mult_plain(rots[i], pt)
            inner = term if inner is None else cc.EvalAdd(inner, term)
        if j:
            inner = cc.EvalRotate(inner, bstep * j)
        outer = inner if outer is None else cc.EvalAdd(outer, inner)
    return outer


def apply_double_angle(cc, ct: Ciphertext, num_iter: int) -> Ciphertext:
    """(reference ApplyDoubleAngleIterations) r steps of ct <- 2*ct^2 -
    (2pi)^(-2^i): the reduced-angle cosine becomes sin(2*pi*K*y)/(2*pi)."""
    for i in range(1 - num_iter, 1):
        scalar = -math.pow(2.0 * math.pi, -math.pow(2.0, i))
        sq = cc.EvalSquare(ct)
        ct = cc.EvalAdd(cc.EvalAdd(sq, sq), scalar)
        if ct.noise_deg > 1:
            ct = cc.ModReduce(ct)
    return ct


# ---------------------------------------------------------------------------
# the pipeline's shared steps
# ---------------------------------------------------------------------------

def raise_and_normalize(cc, p: CKKSBootstrapPrecom, ct: Ciphertext,
                         scalar: float) -> Ciphertext:
    """ModRaise, the normalization multiply (landing on the canonical
    degree-2 scale at level 0), the sparse PartialSum onto the dim-2s
    subring (ckksrns-fhe.cpp:743-745) and a rescale."""
    raised = mod_raise(cc, ct)
    raised = cc._scalar_mult_raw(raised, scalar,
                                 cc.scf_real[0] ** 2 / raised.scale)
    if p.sparse:
        j = p.slots
        while j < cc.ring_dim // 2:
            raised = cc.EvalAdd(raised, cc.EvalRotate(raised, j))
            j <<= 1
    return cc.ModReduce(raised)


def coeffs_to_slots(cc, p: CKKSBootstrapPrecom, raised: Ciphertext) -> list:
    """CoeffsToSlots and the conjugate split: [real] for sparse packing,
    [real, imaginary * X^(3 slots)] otherwise, each rescaled."""
    if p.c2s_stages is not None:
        ctxt_enc = fftt.eval_fft_stages(cc, raised, p.c2s_stages, p.pt_slots)
    else:
        ctxt_enc = eval_linear_transform(cc, raised, p.c2s_diags,
                                         p.bstep_enc, p.pt_slots)
    conj = cc.EvalConjugate(ctxt_enc)
    if p.sparse:
        return [cc.ModReduce(cc.EvalAdd(ctxt_enc, conj))]
    ctxt_enc_i = cc.EvalSub(ctxt_enc, conj)
    ctxt_enc = cc.EvalAdd(ctxt_enc, conj)
    ctxt_enc_i = mult_by_monomial(cc, ctxt_enc_i, 3 * p.slots)
    return [cc.ModReduce(ctxt_enc), cc.ModReduce(ctxt_enc_i)]


def eval_mod(cc, p: CKKSBootstrapPrecom, parts: list) -> Ciphertext:
    """EvalMod of each part (the Chebyshev seed, then the double-angle
    steps), the parts recombined (the imaginary one times X^slots)."""
    out_parts = []
    for part in parts:
        y = cc.EvalChebyshevSeries(part, p.cheb_coeffs, -1.0, 1.0)
        if y.noise_deg > 1:
            y = cc.ModReduce(y)
        out_parts.append(apply_double_angle(cc, y, p.r_iters))
    if p.sparse:
        return out_parts[0]
    return cc.EvalAdd(out_parts[0],
                      mult_by_monomial(cc, out_parts[1], p.slots))


def slots_to_coeffs(cc, p: CKKSBootstrapPrecom,
                     ct: Ciphertext) -> Ciphertext:
    """SlotsToCoeffs, a rescale and the sparse fold."""
    if p.s2c_stages is not None:
        ctxt_dec = fftt.eval_fft_stages(cc, ct, p.s2c_stages, p.pt_slots)
    else:
        ctxt_dec = eval_linear_transform(cc, ct, p.s2c_diags, p.bstep_dec,
                                         p.pt_slots)
    ctxt_dec = cc.ModReduce(ctxt_dec)
    if p.sparse:
        ctxt_dec = cc.EvalAdd(ctxt_dec, cc.EvalRotate(ctxt_dec, p.slots))
    return ctxt_dec


# ---------------------------------------------------------------------------
# the bootstrap pipelines
# ---------------------------------------------------------------------------

def eval_bootstrap(cc, ct: Ciphertext, num_iterations: int = 1,
                   precision: int = 0) -> Ciphertext:
    """(reference EvalBootstrap, ckksrns-fhe.cpp:429) The same message at a
    much lower level."""
    if num_iterations == 2:
        return _eval_bootstrap_two_rounds(cc, ct, precision)
    if ct.slots not in cc._boot_precom:
        raise ValueError(f"no bootstrap precomputation for {ct.slots} slots;"
                         " call EvalBootstrapSetup(slots=...) first")
    if ct.key_tag not in cc.eval_automorphism_keys:
        raise ValueError("bootstrapping keys have not been generated; call "
                         "EvalBootstrapKeyGen before EvalBootstrap")
    p = cc._boot_precom[ct.slots]
    n_levels = len(cc.scf_real)

    # ---- adjust: scale the message down by 2^correction and land
    # canonically on the last level (reference AdjustCiphertext,
    # ckksrns-fhe.cpp:2228) ----
    if ct.noise_deg > 1:
        ct = cc.ModReduce(ct)
    if cc.size_ql(ct.level) < 2 * cc.comp_deg:
        raise ValueError("bootstrap input needs >= 2 levels for the "
                         "correction scale-down")
    l_pen = n_levels - 2
    pt_scale = cc.scf_real[l_pen] ** 2 / ct.scale
    ct = cc._scalar_mult_raw(ct, math.pow(2.0, -p.correction), pt_scale)
    if ct.level < l_pen:
        ct = cc.LevelReduce(ct, l_pen - ct.level)
    ct = cc.ModReduce(ct)           # 1 level, degree 1, scale scf[k-1]

    # ---- ModRaise and normalization: after C2S (+ conj) slots hold
    # z_k / (K * q0) ----
    raised = raise_and_normalize(cc, p, ct, p.runtime_scalar)
    ctxt_mod = eval_mod(cc, p, coeffs_to_slots(cc, p, raised))

    # slots hold mu_k / q0; integer boosts (no noise growth), the residual
    # value factor being folded into the S2C matrix at setup
    if p.boost1 > 1:
        ctxt_mod = mult_by_integer(cc, ctxt_mod, p.boost1)
    ctxt_dec = slots_to_coeffs(cc, p, ctxt_mod)
    if p.boost2 > 1:
        ctxt_dec = mult_by_integer(cc, ctxt_dec, p.boost2)
    return dataclasses.replace(ctxt_dec, slots=ct.slots)


def eval_bootstrap_stc_first(cc, ct: Ciphertext, num_iterations: int = 1,
                             precision: int = 0) -> Ciphertext:
    """(reference EvalBootstrapStCFirst, ckksrns-fhe.cpp:839) The standard
    pipeline reordered: SlotsToCoeffs first at the depleted end, then
    ModRaise -> CoeffsToSlots -> EvalMod, the output in slot form. The
    folded constants are the standard ones; boost2 moves to the end."""
    if ct.slots not in cc._boot_precom:
        raise ValueError(f"no bootstrap precomputation for {ct.slots} slots")
    p = cc._boot_precom[ct.slots]
    n_levels = len(cc.scf_real)

    if num_iterations == 2:
        pow2 = 1 << (precision or 3)
        ct1 = eval_bootstrap_stc_first(cc, ct, 1)
        if ct1.noise_deg > 1:
            ct1 = cc.ModReduce(ct1)
        if ct.level <= ct1.level:
            return ct1
        ct1_down = cc.LevelReduce(ct1, ct.level - ct1.level)
        e_up = cc.EvalSub(
            dataclasses.replace(mult_by_integer(cc, ct1_down, pow2),
                                scale=ct.scale),
            mult_by_integer(cc, ct, pow2))
        err_boot = eval_bootstrap_stc_first(cc, e_up, 1)
        if err_boot.noise_deg > 1:
            err_boot = cc.ModReduce(err_boot)
        return cc.EvalSub(ct1, dataclasses.replace(
            err_boot, scale=err_boot.scale * pow2))

    # ---- deplete to the S2C start level ----
    if ct.noise_deg > 1:
        ct = cc.ModReduce(ct)
    l_dec = len(p.s2c_stages) if p.s2c_stages is not None else 1
    need = l_dec + 2                        # S2C levels + adjust + floor
    # levels, comp_deg towers each (the JAX package compares the towers
    # with the levels, so a composite input one level short passes its
    # check and runs out of towers in ModRaise)
    if cc.size_ql(ct.level) < need * cc.comp_deg:
        raise ValueError("StC-first bootstrap input needs at least "
                         f"{need} levels ({need * cc.comp_deg} towers)")
    target_lvl = n_levels - need
    if ct.level < target_lvl:
        ct = cc.LevelReduce(ct, target_lvl - ct.level)

    ctxt_dec = slots_to_coeffs(cc, p, ct)

    # ---- adjust (2^-correction) and land canonically on 1 level ----
    l_pen = n_levels - 2
    pt_scale = cc.scf_real[l_pen] ** 2 / ctxt_dec.scale
    ctxt_dec = cc._scalar_mult_raw(ctxt_dec, math.pow(2.0, -p.correction),
                                   pt_scale)
    ctxt_dec = cc.ModReduce(ctxt_dec)

    raised = raise_and_normalize(cc, p, ctxt_dec, p.runtime_scalar)
    ctxt_mod = eval_mod(cc, p, coeffs_to_slots(cc, p, raised))

    # ---- boosts (no trailing S2C: the output is in slot form) ----
    if p.boost1 > 1:
        ctxt_mod = mult_by_integer(cc, ctxt_mod, p.boost1)
    if p.boost2 > 1:
        ctxt_mod = mult_by_integer(cc, ctxt_mod, p.boost2)
    return dataclasses.replace(ctxt_mod, slots=ct.slots)


def _eval_bootstrap_two_rounds(cc, ct: Ciphertext, precision: int
                               ) -> Ciphertext:
    """Meta-BTS (reference EvalBootstrap numIterations=2,
    ckksrns-fhe.cpp:465-512): bootstrap once, scale the residual error up
    by 2^precision, bootstrap the error, subtract the refined estimate."""
    if precision == 0:
        # |2^p * e1| must stay inside the sine's accurate range
        precision = 3
    pow2 = 1 << precision

    if ct.noise_deg > 1:
        ct = cc.ModReduce(ct)

    ct1 = eval_bootstrap(cc, ct, 1)                    # step 3
    if ct1.noise_deg > 1:
        ct1 = cc.ModReduce(ct1)

    if ct.level <= ct1.level:
        # the input had at least as many towers as one bootstrap gives
        # (reference :477-479)
        return ct

    # steps 2/4: both scaled up by 2^p as integer multiplies
    ct1_up = mult_by_integer(cc, ct1, pow2)
    ct_up = mult_by_integer(cc, ct, pow2)

    # steps 5-7: down to the input's level and subtract (EvalSub's FLEXIBLE
    # alignment matches the per-level scales), leaving 2^p * e1
    ct1_down = cc.LevelReduce(ct1_up, ct.level - ct1_up.level)
    e_up = cc.EvalSub(ct1_down, ct_up)

    err_boot = eval_bootstrap(cc, e_up, 1)             # step 8
    if err_boot.noise_deg > 1:
        err_boot = cc.ModReduce(err_boot)

    # steps 9-10: refine, then divide by 2^p with a scalar multiply
    out = cc.EvalSub(ct1_up, err_boot)
    return cc.EvalMult(out, 1.0 / pow2)
