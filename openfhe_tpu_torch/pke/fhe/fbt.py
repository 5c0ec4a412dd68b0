"""EvalFBT: vectorized functional bootstrapping on CKKS.

Counterpart of `openfhe_tpu/pke/fhe/fbt.py` (reference analog:
ckksrns-fhe.cpp EvalFBTSetup :2945, EvalMVBPrecompute :3008-3280, EvalFBT,
EvalHomDecoding :2964, on the RLWE schemelet of `pke/schemelet.py`): a
look-up table over Z_p digits packed in the coefficients of an RLWE
ciphertext, evaluated homomorphically on every digit at once.

Method, as the JAX package's:
  1. the schemelet ciphertext (digits m_k at scale q0/p) converts to a CKKS
     ciphertext on the last level and is modulus-raised: z = m*q0/p + q0*I;
  2. CoeffsToSlots moves coefficients into slots, normalized to
     y = z/(K*q0) in [-1,1];
  3. a Chebyshev seed of exp(2*pi*i*K*y/4) and two squarings give
     E = exp(2*pi*i*z/q0) = omega_p^m (the exponential's period absorbs
     q0*I: no correction factor, no sine linearization error);
  4. the LUT f: Z_p -> Z is its Fourier series sum_j c_j E^j;
  5. EvalHomDecoding (SlotsToCoeffs) returns to coefficient packing.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from openfhe_tpu_torch.pke.ciphertext import Ciphertext
from openfhe_tpu_torch.pke.fhe import ckks_bootstrap as bt


def eval_fbt_setup(cc, num_slots: int = 0, p_in: int = 8,
                   correction_factor: int = 0) -> None:
    """(reference EvalFBTSetup) The bootstrap's dense C2S / S2C precompute
    and the exponential seed's Chebyshev coefficients."""
    slots = num_slots or cc.ring_dim // 2
    bt.eval_bootstrap_setup(cc, slots=slots,
                            correction_factor=correction_factor or 4)
    p = cc._boot_precom[slots]
    k_bound = p.k_bound
    p.exp_coeffs = bt._interpolate(
        lambda y: np.exp(2j * np.pi * (k_bound * np.asarray(y)) / 4.0))


def eval_fbt_keygen(cc, sk, slots: int = 0) -> None:
    bt.eval_bootstrap_keygen(cc, sk, slots)


def _eval_powers(cc, e: Ciphertext, upto: int) -> dict:
    """E^1..E^upto by binary products of log depth (reference
    EvalPowers)."""
    pows = {1: e}
    for j in range(2, upto + 1):
        half = j // 2
        if j % 2 == 0:
            pows[j] = cc.EvalMult(pows[half], pows[half])
        else:
            pows[j] = cc.EvalMult(pows[half + 1], pows[half])
    return pows


class SeriesPowers:
    """Shared exponential powers (reference seriesPowers<Element>,
    cryptocontext.h:2716): the raise, C2S, exponential and power basis of
    a functional bootstrap, reused by every LUT (EvalMVB)."""

    def __init__(self, parts_pows, sparse, slots, orig_slots, p_in):
        self.parts_pows = parts_pows   # per part: dict j -> E^j ciphertext
        self.sparse = sparse
        self.slots = slots
        self.orig_slots = orig_slots
        self.p_in = p_in


def eval_mvb_precompute(cc, ct: Ciphertext, p_in: int) -> SeriesPowers:
    """(reference EvalMVBPrecompute, ckksrns-fhe.cpp:3008) Raise, C2S, the
    exponential and its powers."""
    p = cc._boot_precom[ct.slots]
    if p.exp_coeffs is None:
        raise ValueError("call EvalFBTSetup before EvalFBT/EvalMVB")
    k_chain = len(cc.moduli_q)
    q0 = cc.moduli_q[0]

    # ---- raise (no correction: the exponential is exact over q0*I),
    # then CoeffsToSlots ----
    if ct.noise_deg > 1:
        ct = cc.ModReduce(ct)
    if cc.size_ql(ct.level) > 1:
        ct = cc.LevelReduce(ct, k_chain - 1 - ct.level)
    sigma_in = ct.scale                       # = q0 / p_in
    raised = bt.raise_and_normalize(
        cc, p, ct, sigma_in / (float(cc.ring_dim) * float(q0)))
    parts = bt.coeffs_to_slots(cc, p, raised)

    parts_pows = []
    for part in parts:
        e = cc.EvalChebyshevSeries(part, p.exp_coeffs, -1.0, 1.0)
        if e.noise_deg > 1:
            e = cc.ModReduce(e)
        for _ in range(2):                    # exp(t/4) -> exp(t)
            e = cc.EvalMult(e, e)
        parts_pows.append(_eval_powers(cc, e, p_in - 1))
    return SeriesPowers(parts_pows, p.sparse, p.slots, ct.slots, p_in)


def eval_mvb(cc, powers: SeriesPowers, lut, p_in: int,
             decode: bool = True, p_out: int = 0) -> Ciphertext:
    """(reference EvalMVB) One LUT's Fourier series on the precomputed
    powers; `decode` runs EvalHomDecoding afterwards."""
    lut = np.asarray(lut, np.float64)
    if len(lut) != p_in or p_in != powers.p_in:
        raise ValueError("lut must have p_in entries matching the "
                         "precompute")
    # E = exp(+2 pi i m / p), so f(m) = sum_j c_j E^j with
    # c_j = (1/p) sum_m f(m) exp(-2 pi i j m / p) = FFT(f)/p
    fourier = np.fft.fft(lut) / p_in

    outs = []
    for pows in powers.parts_pows:
        acc = None
        for j in range(1, p_in):
            cj = fourier[j]
            if abs(cj) < 1e-14:
                continue
            term = cc.EvalMult(pows[j], complex(cj))
            acc = term if acc is None else cc.EvalAdd(acc, term)
        acc = cc.EvalAdd(acc, complex(fourier[0])) if acc is not None \
            else cc.EvalAdd(cc.EvalMult(pows[1], 0.0), complex(fourier[0]))
        outs.append(acc)

    if powers.sparse:
        ctxt_val = outs[0]
    else:
        enc_i = bt.mult_by_monomial(cc, outs[1], powers.slots)
        ctxt_val = cc.EvalAdd(outs[0], enc_i)

    if not decode:
        return dataclasses.replace(ctxt_val, slots=powers.orig_slots)
    return eval_hom_decoding(cc, ctxt_val, p_out or p_in,
                             powers.orig_slots)


def eval_hom_decoding(cc, ctxt_val: Ciphertext, p_out: int,
                      orig_slots: int | None = None) -> Ciphertext:
    """(reference EvalHomDecoding, ckksrns-fhe.cpp:2964) SlotsToCoeffs and
    an exact integer post-scaling to the schemelet's Q_level/p_out
    coefficient encoding."""
    p = cc._boot_precom[orig_slots or ctxt_val.slots]
    k_chain = len(cc.moduli_q)
    q0 = cc.moduli_q[0]
    if ctxt_val.noise_deg > 1:
        ctxt_val = cc.ModReduce(ctxt_val)
    ctxt_dec = bt.slots_to_coeffs(cc, p, ctxt_val)
    # the S2C diagonals carry the bootstrap's dec_scale; undo it in the
    # tracked scale
    ctxt_dec = dataclasses.replace(ctxt_dec, scale=ctxt_dec.scale / (
        p.boost1 * p.boost2 * math.pow(2.0, -p.correction)
        * cc.scf_real[k_chain - 1] / float(q0)))
    # post-scaling: one exact integer multiply up to Q_level/p_out
    q_level = math.prod(cc.moduli_q[:cc.size_ql(ctxt_dec.level)])
    post = q_level // max(1, int(round(p_out * ctxt_dec.scale)))
    if post > 1:
        ctxt_dec = bt.mult_by_integer(cc, ctxt_dec, post)
        ctxt_dec = dataclasses.replace(ctxt_dec, scale=ctxt_dec.scale * post)
    if orig_slots:
        ctxt_dec = dataclasses.replace(ctxt_dec, slots=orig_slots)
    return ctxt_dec


def eval_fbt(cc, ct: Ciphertext, lut, p_in: int,
             decode: bool = True, p_out: int = 0) -> Ciphertext:
    """`lut` (a table over Z_{p_in}) on every packed digit: slots
    (decode=False) or coefficients (decode=True) holding lut[m_k]."""
    powers = eval_mvb_precompute(cc, ct, p_in)
    return eval_mvb(cc, powers, lut, p_in, decode, p_out)
