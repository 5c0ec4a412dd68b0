"""SchemeletRLWEMP: coefficient-encoded additive RLWE for EvalFBT.

Counterpart of `openfhe_tpu/pke/schemelet.py` (reference analog:
schemelet/rlwe-mp.cpp EncryptCoeff :132, DecryptCoeff :203, ModSwitch :252,
ConvertRLWEToCKKS :259, ConvertCKKSToRLWE :282, GetQPrime :305): an
additive-BFV schemelet whose ciphertexts are big-integer coefficient
polynomials mod an arbitrary Q, the bridge between CKKS ciphertexts and
EvalFBT / EvalMVB. These are data-boundary operations, once per FBT call:
they run on the host with exact Python ints through `math/crt`, as the
reference runs them on its BigInteger Poly type; the NTTs and the
products with the secret run on the context's device.
"""

from __future__ import annotations

import math

import numpy as np

from openfhe_tpu_torch.math import crt, sampling
from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from openfhe_tpu_torch.pke.ciphertext import Ciphertext


def _bit_reverse(vals):
    n = len(vals)
    out = list(vals)
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j >= bit:
            j -= bit
            bit >>= 1
        j += bit
        if i < j:
            out[i], out[j] = out[j], out[i]
    return out


def _bit_reverse_two_halves(vals):
    n = len(vals) // 2
    return _bit_reverse(vals[:n]) + _bit_reverse(vals[n:])


def _switch_centered(vals, q_to: int, q_from: int):
    """Centred exact modulus switch: round(center(v) * q_to / q_from) mod
    q_to (the reference's SwitchModulus + MultiplyAndRound on big-integer
    Polys, rlwe-mp.cpp ModSwitchUp/Down)."""
    half_from = q_from >> 1
    out = np.empty(len(vals), object)
    for i, v in enumerate(vals):
        c = int(v)
        if c > half_from:
            c -= q_from
        out[i] = ((2 * c * q_to + q_from) // (2 * q_from)) % q_to
    return out


def _coeffs(x, basis) -> np.ndarray:
    """EVAL residues on the device -> Python-int coefficients in [0, Q)."""
    return crt.interpolate(mo.to_u32(ntt_inv(x, basis)), basis.moduli)[0]


def _eval(cc, big, basis):
    """Python-int coefficients -> EVAL residues on the context's device."""
    res = crt.to_residues_host(big, tuple(basis.moduli))
    return ntt_fwd(mo.u32_tensor(res, cc.device), basis)


class SchemeletRLWEMP:
    """(reference SchemeletRLWEMP, schemelet/rlwe-mp.h:45)"""

    @staticmethod
    def get_q_prime(cc, level: int = 0) -> int:
        """Product of the first (len - level) CKKS moduli."""
        return math.prod(cc.moduli_q[:len(cc.moduli_q) - level])

    @staticmethod
    def encrypt_coeff(cc, sk, values, big_q: int, p: int,
                      level: int = 0, bit_reverse: bool = False):
        """RLWE encryption of integer coefficients at scale Q/p, as a pair
        of Python-int coefficient arrays mod big_q (reference EncryptCoeff
        :132)."""
        size = len(cc.moduli_q) - level
        basis = cc.basis_q.slice(0, size)
        n = cc.ring_dim
        a = sampling.uniform_residues(cc._gen, basis)
        e = ntt_fwd(sampling.to_residues(
            sampling.discrete_gaussian(cc._gen, (n,)), basis), basis)
        b = mo.sub_mod(e, mo.mul_mod(a, sk.s_qp[:size], basis.q), basis.q)
        q_prime = math.prod(basis.moduli)
        a_big = _coeffs(a, basis)
        b_big = _coeffs(b, basis)
        if big_q != q_prime:
            a_big = _switch_centered(a_big, big_q, q_prime)
            b_big = _switch_centered(b_big, big_q, q_prime)
        # the message at stride gap, scaled by Q/p
        vals = [int(v) for v in values]
        gap = n // (2 * len(vals))
        if bit_reverse:
            vals = _bit_reverse_two_halves(vals) if gap == 0 \
                else _bit_reverse(vals)
        gap = max(gap, 1)
        delta = big_q // p
        limit = min(len(vals), n)
        for i in range(limit):
            entry = vals[i] % big_q
            b_big[i * gap] = (int(b_big[i * gap]) + delta * entry) % big_q
            if gap > 1:
                b_big[(i + limit) * gap] = (int(b_big[(i + limit) * gap])
                                            + delta * entry) % big_q
        return [b_big, a_big]

    @staticmethod
    def decrypt_coeff(cc, sk, ct_polys, big_q: int, p: int,
                      level: int = 0, num_slots: int = 0, length: int = 0,
                      bit_reverse: bool = False):
        """(reference DecryptCoeff :203)"""
        size = len(cc.moduli_q) - level
        basis = cc.basis_q.slice(0, size)
        n = cc.ring_dim
        q_prime = math.prod(basis.moduli)
        b_big, a_big = ct_polys
        a_e = _eval(cc, _switch_centered(a_big, q_prime, big_q), basis)
        b_e = _eval(cc, _switch_centered(b_big, q_prime, big_q), basis)
        m_e = mo.add_mod(b_e, mo.mul_mod(a_e, sk.s_qp[:size], basis.q),
                         basis.q)
        m_big = _coeffs(m_e, basis)
        if big_q != q_prime:
            m_big = _switch_centered(m_big, big_q, q_prime)
        m_p = _switch_centered(m_big, p, big_q)
        num_slots = num_slots or n // 2
        gap = n // (2 * num_slots)
        length = length or num_slots
        half = p >> 1
        out = []
        for i in range(length):
            v = int(m_p[i * gap])
            out.append(v - p if v > half else v)
        if bit_reverse:
            out = _bit_reverse_two_halves(out) if num_slots < length \
                else _bit_reverse(out)
        return np.array(out, np.int64)

    @staticmethod
    def mod_switch(ct_polys, q_to: int, q_from: int):
        """(reference ModSwitch :252)"""
        return [_switch_centered(ct_polys[0], q_to, q_from),
                _switch_centered(ct_polys[1], q_to, q_from)]

    @staticmethod
    def convert_rlwe_to_ckks(cc, ct_polys, big_q: int, slots: int,
                             level: int = 0, scale: float | None = None
                             ) -> Ciphertext:
        """An RLWE coefficient pair as a CKKS ciphertext at `level`
        (reference ConvertRLWEToCKKS :259)."""
        basis = cc.basis_q.slice(0, len(cc.moduli_q) - level)
        q_prime = math.prod(basis.moduli)
        b = _eval(cc, _switch_centered(ct_polys[0], q_prime, big_q), basis)
        a = _eval(cc, _switch_centered(ct_polys[1], q_prime, big_q), basis)
        return Ciphertext(elements=(b, a), level=level, noise_deg=1,
                          scale=scale or cc.scale_at(level), slots=slots,
                          key_tag="schemelet")

    @staticmethod
    def convert_ckks_to_rlwe(cc, ct: Ciphertext, big_q: int):
        """(reference ConvertCKKSToRLWE :282)"""
        basis = cc.basis_at(ct.level)
        q_prime = math.prod(basis.moduli)
        return [_switch_centered(_coeffs(c, basis), big_q, q_prime)
                for c in ct.elements[:2]]
