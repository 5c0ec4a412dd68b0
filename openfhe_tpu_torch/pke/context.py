"""CryptoContext: the user-facing FHE API (CKKS subset).

Counterpart of the CKKS part of `openfhe_tpu/pke/context.py` (reference
analog: cryptocontext.h). The context is a host object holding the bases,
the conversion tables (built lazily per level) and the key stores, all on
one device. Method names mirror the reference.

Ported: CKKS with HYBRID key switching under every scaling technique
(FIXEDMANUAL, FIXEDAUTO, FLEXIBLEAUTO, FLEXIBLEAUTOEXT and
COMPOSITESCALING{AUTO,MANUAL}: the per-level scales `scf_real`, the
extension modulus, `comp_deg` towers a level). Every key switch goes
through `hybrid.keyswitch_core` and EvalMult of two 2-element ciphertexts
through `mult_relin_hybrid`: on a CUDA context each is one chain of fused
kernels (`ks_fused.keyswitch_core_fused` for Relinearize, KeySwitch and
every automorphism, `ks_fused.mult_relin_fused` for EvalMult), on the CPU
the unfused chain, with the same words. The leveled layer: EvalAdd,
EvalSub and EvalMult with ciphertext, plaintext and scalar operands,
EvalNegate, EvalSquare, EvalMultAndRelinearize, the level and degree
alignment of each scaling technique (the x1 plaintext multiply, the
FLEXIBLE scalar multiply), ModReduce / Rescale, LevelReduce, Compress,
noise-flooding decryption and EXEC_NOISE_ESTIMATION's log error, and the
InPlace / Mutable / NoCheck aliases. Rotations: automorphism keys
(`eval_automorphism_keys[key_tag][g]`), EvalAutomorphism / EvalRotate /
EvalAtIndex / EvalConjugate, the hoisted EvalFastRotation. `advanced.py`:
the rotation ladders (EvalSum, EvalSumRows, EvalSumCols,
EvalInnerProduct), EvalLinearWSum, EvalMerge, the power-basis polynomials
and the Chebyshev series with EvalChebyshevFunction, EvalSin, EvalCos,
EvalLogistic and EvalDivide.

Not ported (NotImplementedError or absent): BGV and BFV, BV key
switching, the extended-basis ops (KeySwitchExt, EvalFastRotationExt,
KeySwitchDown), EvalHermiteTrigSeries, JitPipeline, serialization,
multiparty, PRE, the bootstrap and scheme switching. Ciphertexts of three
or more elements are refused where the JAX package reads two and drops
the rest.

Devices are explicit: the context's tensors live on `device`, `cuda` when
None (it raises if there is no GPU). Randomness comes from one
`torch.Generator` on that device, seeded from `seed`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from openfhe_tpu_torch._device import resolve_device
from openfhe_tpu_torch.lattice import rns_tools as rt
from openfhe_tpu_torch.lattice.automorph import (conjugation_index,
                                                 eval_indices,
                                                 rotation_automorphism_index)
from openfhe_tpu_torch.lattice.basis import Basis, make_basis
from openfhe_tpu_torch.lattice.dcrt import COEFF, EVAL, Poly
from openfhe_tpu_torch.math import crt
from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.ops.ntt import ntt_fwd
from openfhe_tpu_torch.pke import advanced
from openfhe_tpu_torch.pke import parameters as prm
from openfhe_tpu_torch.pke.ciphertext import Ciphertext, Plaintext
from openfhe_tpu_torch.math import sampling
from openfhe_tpu_torch.pke.constants import (DecryptionNoiseMode,
                                             ExecutionMode,
                                             KeySwitchTechnique,
                                             PKESchemeFeature,
                                             ScalingTechnique, Scheme)
from openfhe_tpu_torch.pke.encoding import ckks_packed
from openfhe_tpu_torch.pke.keys import EvalKey, KeyPair, PrivateKey, PublicKey
from openfhe_tpu_torch.pke.keyswitch import hybrid, ks_fused
from openfhe_tpu_torch.pke.schemes import rns_pke


def mult_relin_hybrid(a0, a1, b0, b1, ek: EvalKey,
                      tabs: hybrid.HybridTables):
    """Tensor product + relinearization, as the JAX package's
    `_k_mult_relin_hybrid`: the fused chain `ks_fused.mult_relin_fused`
    when the level's tables carry it (a CUDA context), else Karatsuba
    c1 = (a0+a1)(b0+b1) - c0 - c2 with c2 key-switched by the unfused
    `hybrid.keyswitch_core` and folded into (c0, c1). Both give the same
    words."""
    if tabs.fused is not None:
        hybrid.require_companions(ek)
        return ks_fused.mult_relin_fused(a0, a1, b0, b1, ek.bv, ek.av,
                                         ek.bv_sh, ek.av_sh, tabs.fused)
    q = tabs.basis_ql.q
    c0 = mo.mul_mod(a0, b0, q)
    c2 = mo.mul_mod(a1, b1, q)
    cross = mo.mul_mod(mo.add_mod(a0, a1, q), mo.add_mod(b0, b1, q), q)
    c1 = mo.sub_mod(mo.sub_mod(cross, c0, q), c2, q)
    return relin_hybrid(c0, c1, c2, ek, tabs)


def relin_hybrid(e0, e1, e2, ek: EvalKey, tabs: hybrid.HybridTables):
    """(e0, e1, e2) -> (e0 + d0, e1 + d1) with (d0, d1) the key switch of
    e2, as the JAX package's `_k_relin_hybrid`."""
    return hybrid.keyswitch_core(e2, ek, tabs, e0, e1)


def automorph_hybrid(elems, idx: torch.Tensor, ek: EvalKey,
                     tabs: hybrid.HybridTables):
    """sigma_g of a 2-element ciphertext, as the JAX package's
    `_k_automorph_hybrid`: both elements gathered with the EVAL table
    `idx`, the second key-switched from s(X^g) back to s, its first half
    added to the first."""
    rot = [torch.index_select(c, -1, idx) for c in elems]
    return hybrid.keyswitch_core(rot[1], ek, tabs, rot[0])


class CryptoContext:
    """One instantiated CKKS scheme (parameters frozen, tables cached)."""

    def __init__(self, params: prm.CCParams, seed: int = 0, device=None):
        params.validate()
        if params.scheme != Scheme.CKKSRNS_SCHEME:
            raise NotImplementedError(f"{params.scheme} is not ported yet")
        if params.ks_technique != KeySwitchTechnique.HYBRID:
            raise NotImplementedError("only HYBRID key switching is ported")
        self.device = resolve_device(device)
        self.params = params
        self.scheme = params.scheme
        self._features = PKESchemeFeature(0)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._key_counter = 0
        self._init_ckks()
        self._hybrid_cache: dict = {}
        self._rescale_cache: dict = {}
        self.eval_mult_keys: dict = {}
        self.eval_automorphism_keys: dict = {}   # key_tag -> {g: EvalKey}
        self._auto_idx_cache: dict = {}

    # ------------------------------------------------------------------
    # parameter generation
    # ------------------------------------------------------------------

    def _init_ckks(self):
        p = self.params
        if p.ring_dim == 0:
            est_log = p.first_mod_size + p.mult_depth * p.scaling_mod_size
            est_log += est_log / max(1, p.num_large_digits)  # + logP
            p.ring_dim = prm.derive_ring_dim(p, est_log)
        n = self.ring_dim = p.ring_dim
        self.comp_deg = p.composite_degree if self._composite() else 1
        if self.comp_deg > 1:
            self.moduli_q = prm.select_ckks_moduli_composite(
                n, p.mult_depth, p.scaling_mod_size, p.first_mod_size,
                self.comp_deg)
        else:
            self.moduli_q = prm.select_ckks_moduli(
                n, p.mult_depth, p.scaling_mod_size, p.first_mod_size,
                flexible=self._flexible(),
                ext_mod_size=(prm.DEFAULT_EXTRA_MOD_SIZE
                              if self._flexible_ext() else 0))
        self.moduli_p = prm.select_aux_moduli(n, self.moduli_q,
                                              p.num_large_digits,
                                              p.aux_mod_size)
        log_qp = sum(math.log2(q) for q in self.moduli_q + self.moduli_p)
        prm.validate_security(p, n, log_qp)
        dev = self.device
        self.basis_q = make_basis(self.moduli_q, n, device=dev)
        self.basis_p = make_basis(self.moduli_p, n, device=dev)
        self.basis_qp = self.basis_q.concat(self.basis_p)
        self.big_p = math.prod(self.moduli_p)
        pm = [self.big_p % q for q in self.moduli_q] + [0] * len(self.moduli_p)
        self.p_modq, self.p_modq_sh = mo.shoup_pair(
            pm, self.moduli_q + self.moduli_p, dev)
        self.delta = float(2 ** p.scaling_mod_size)
        self.slots = p.batch_size or n // 2
        self.scf_real = self._scaling_factors()

    def _scaling_factors(self) -> list:
        """The scale of a depth-1 ciphertext at each level (reference
        m_scalingFactorsReal, ckksrns-cryptoparameters.cpp). FLEXIBLE and
        composite: level 0 anchors on the moduli dropped first, then
        scf[l+1] = scf[l]^2 / drop_factor(l); FLEXIBLEAUTOEXT anchors on
        sqrt(q_ext * q_top), so a fresh encoding's degree-2 scale is
        q_ext * q_top. FIXED: 2^p at every level. Python floats in the
        JAX package's order of operations: every encoded word depends on
        them."""
        k, d = len(self.moduli_q), self.comp_deg
        n_levels = (k - d) // d + 1 if d > 1 else k
        if not (self._flexible() or self._composite()):
            return [self.delta] * n_levels
        if self._flexible_ext():
            scf = [math.sqrt(float(self.moduli_q[-1])
                             * float(self.moduli_q[-2]))]
        else:
            scf = [float(self.drop_factor(0))]
        for lvl in range(1, n_levels):
            scf.append(scf[-1] * scf[-1] / float(self.drop_factor(lvl - 1)))
        return scf

    def drop_factor(self, level: int) -> int:
        """Product of the moduli dropped when rescaling from `level`."""
        hi = len(self.moduli_q) - self.comp_deg * level
        return math.prod(self.moduli_q[hi - self.comp_deg:hi])

    # ------------------------------------------------------------------
    # infrastructure
    # ------------------------------------------------------------------

    def Enable(self, feature: PKESchemeFeature) -> None:
        self._features |= feature

    # -- accessors under the reference's names (cryptocontext.h) --------
    def GetRingDimension(self) -> int:
        return self.ring_dim

    def GetCyclotomicOrder(self) -> int:
        return 2 * self.ring_dim

    def GetCryptoParameters(self):
        return self.params

    GetEncodingParams = GetCryptoParameters

    def GetElementParams(self) -> Basis:
        return self.basis_q

    def GetModulus(self) -> int:
        return math.prod(self.moduli_q)

    def GetRootOfUnity(self) -> int:
        """The 2N-th root of the first tower: psi_br[0, j] holds
        psi^brv(j), so index brv^-1(1) = N / 2 holds psi."""
        return int(self.basis_q.psi_br[0, self.ring_dim // 2])

    def GetScheme(self):
        return self.scheme

    def GetKeyGenLevel(self) -> int:
        return getattr(self, "_keygen_level", 0)

    def SetKeyGenLevel(self, level: int) -> None:
        self._keygen_level = level

    def GetCKKSDataType(self):
        return self.params.ckks_data_type

    def GetAllEvalMultKeys(self) -> dict:
        return self.eval_mult_keys

    def GetEvalMultKeyVector(self, key_tag: str) -> list:
        return [self.eval_mult_keys[key_tag]]

    def size_ql(self, level: int) -> int:
        return len(self.moduli_q) - self.comp_deg * level

    def basis_at(self, level: int) -> Basis:
        return self.basis_q.slice(0, self.size_ql(level))

    def scale_at(self, level: int) -> float:
        """Scaling factor of a depth-1 ciphertext at `level`."""
        return self.scf_real[level]

    def _auto(self) -> bool:
        return self.params.scaling_technique in (
            ScalingTechnique.FIXEDAUTO, ScalingTechnique.FLEXIBLEAUTO,
            ScalingTechnique.FLEXIBLEAUTOEXT,
            ScalingTechnique.COMPOSITESCALINGAUTO)

    def _flexible(self) -> bool:
        return self.params.scaling_technique in (
            ScalingTechnique.FLEXIBLEAUTO, ScalingTechnique.FLEXIBLEAUTOEXT,
            ScalingTechnique.COMPOSITESCALINGAUTO,
            ScalingTechnique.COMPOSITESCALINGMANUAL)

    def _flexible_ext(self) -> bool:
        return (self.params.scaling_technique
                == ScalingTechnique.FLEXIBLEAUTOEXT)

    def _composite(self) -> bool:
        return self.params.scaling_technique in (
            ScalingTechnique.COMPOSITESCALINGAUTO,
            ScalingTechnique.COMPOSITESCALINGMANUAL)

    def hybrid_tables(self, size_ql: int) -> hybrid.HybridTables:
        if size_ql not in self._hybrid_cache:
            self._hybrid_cache[size_ql] = hybrid.make_hybrid_tables(
                self.basis_q, self.basis_p, size_ql,
                self.params.num_large_digits)
        return self._hybrid_cache[size_ql]

    def rescale_tables(self, size_ql: int) -> rt.DropScaleTables:
        if size_ql not in self._rescale_cache:
            self._rescale_cache[size_ql] = rt.make_drop_scale_tables(
                tuple(self.moduli_q[:size_ql]), self.device)
        return self._rescale_cache[size_ql]

    # ------------------------------------------------------------------
    # key generation
    # ------------------------------------------------------------------

    def KeyGen(self) -> KeyPair:
        self._key_counter += 1
        return rns_pke.keygen(self._gen, self.basis_qp,
                              f"key-{self._key_counter}",
                              self.params.secret_key_dist,
                              self.params.standard_deviation)

    def KeySwitchGen(self, old_key: PrivateKey,
                     new_key: PrivateKey) -> EvalKey:
        return hybrid.keyswitch_gen(
            self._gen, old_key, new_key, self.basis_qp, len(self.moduli_q),
            self.params.num_large_digits, self.p_modq, self.p_modq_sh)

    def EvalMultKeyGen(self, sk: PrivateKey) -> None:
        """Relinearization key: s^2 -> s (reference cryptocontext.h:1764)."""
        s_sq = mo.mul_mod(sk.s_qp, sk.s_qp, self.basis_qp.q)
        sk2 = PrivateKey(s_qp=s_sq, key_tag=sk.key_tag)
        self.eval_mult_keys[sk.key_tag] = self.KeySwitchGen(sk2, sk)

    def _automorphism_keygen(self, sk: PrivateKey, g: int) -> EvalKey:
        """Key switching s(X^g) -> s."""
        s_g = torch.index_select(sk.s_qp, -1, self._auto_idx(g))
        return self.KeySwitchGen(PrivateKey(s_qp=s_g, key_tag=sk.key_tag),
                                 sk)

    def EvalAutomorphismKeyGen(self, sk: PrivateKey, g_list) -> None:
        store = self.eval_automorphism_keys.setdefault(sk.key_tag, {})
        for g in g_list:
            if g not in store:
                store[g] = self._automorphism_keygen(sk, g)

    def EvalRotateKeyGen(self, sk: PrivateKey, index_list) -> None:
        """(reference: EvalAtIndexKeyGen / EvalRotateKeyGen)"""
        self.EvalAutomorphismKeyGen(
            sk, [rotation_automorphism_index(r, self.ring_dim)
                 for r in index_list])

    EvalAtIndexKeyGen = EvalRotateKeyGen

    def EvalConjugateKeyGen(self, sk: PrivateKey) -> None:
        self.EvalAutomorphismKeyGen(sk, [conjugation_index(self.ring_dim)])

    def InsertEvalAutomorphismKey(self, key_map: dict, key_tag: str) -> None:
        self.eval_automorphism_keys.setdefault(key_tag, {}).update(key_map)

    # ------------------------------------------------------------------
    # encoding
    # ------------------------------------------------------------------

    def MakeCKKSPackedPlaintext(self, values, scale_deg: int = 1,
                                level: int = 0, slots: int | None = None,
                                scale: float | None = None) -> Plaintext:
        slots = slots or min(self.slots, self.ring_dim // 2)
        if (scale is None and level == 0 and scale_deg == 1
                and self._flexible_ext()):
            # FLEXIBLEAUTOEXT encodes fresh values at the degree-2 scale
            # q_ext * q_top (reference GetScalingFactorRealBig); the first
            # rescale drops q_ext
            scale_deg = 2
        if scale is None:
            scale = self.scale_at(level) ** scale_deg
        coeffs = ckks_packed.encode_to_coeffs(values, self.ring_dim, slots,
                                              scale)
        res = crt.to_residues_host(coeffs,
                                   tuple(self.moduli_q[:self.size_ql(level)]))
        poly = ntt_fwd(mo.u32_tensor(res, self.device), self.basis_at(level))
        return Plaintext(poly=poly, fmt=EVAL, level=level,
                         noise_deg=scale_deg, scale=scale, slots=slots,
                         values=np.asarray(values))

    def decode_ckks(self, coeff_residues: np.ndarray, level: int,
                    scale: float, slots: int) -> np.ndarray:
        size = coeff_residues.shape[-2]
        vals = crt.interpolate_centered_float(coeff_residues,
                                              tuple(self.moduli_q[:size]))
        return ckks_packed.decode_from_coeffs(vals, self.ring_dim, slots,
                                              scale)

    # ------------------------------------------------------------------
    # encrypt / decrypt
    # ------------------------------------------------------------------

    def Encrypt(self, key, plaintext: Plaintext) -> Ciphertext:
        basis = self.basis_at(plaintext.level)
        if isinstance(key, KeyPair):
            key = key.public_key
        if isinstance(key, PublicKey):
            c0, c1 = rns_pke.encrypt_zero_pk(self._gen, key, basis,
                                             self.params.secret_key_dist)
        else:
            c0, c1 = rns_pke.encrypt_zero_sk(self._gen, key, basis)
        c0 = mo.add_mod(c0, plaintext.poly, basis.q)
        return Ciphertext(elements=(c0, c1), level=plaintext.level,
                          noise_deg=plaintext.noise_deg,
                          scale=plaintext.scale, slots=plaintext.slots,
                          key_tag=key.key_tag)

    def Decrypt(self, sk: PrivateKey, ct: Ciphertext) -> Plaintext:
        """Decrypt and decode. With NOISE_FLOODING_DECRYPT in
        EXEC_EVALUATION and a noise estimate, Gaussian noise of sigma
        2^noise_estimate (at most 2^30) is added to the coefficients first
        (reference ckks-noise-flooding.cpp), sampled in int64 so the +-6
        sigma clip cannot wrap. Under EXEC_NOISE_ESTIMATION the largest
        imaginary part of a real computation estimates the noise
        (`log_error`, reference GetLogError)."""
        p = self.params
        basis = self.basis_at(ct.level)
        b = rns_pke.decrypt_core(ct.elements, sk, basis)
        if (p.decryption_noise_mode
                == DecryptionNoiseMode.NOISE_FLOODING_DECRYPT
                and p.execution_mode == ExecutionMode.EXEC_EVALUATION
                and p.noise_estimate > 0):
            sigma = min(2.0 ** p.noise_estimate, 2.0 ** 30)
            flood = sampling.discrete_gaussian(self._gen, (self.ring_dim,),
                                               sigma, dtype=torch.int64)
            b = mo.add_mod(b, sampling.to_residues(flood, basis), basis.q)
        vals = self.decode_ckks(mo.to_u32(b), ct.level, ct.scale, ct.slots)
        log_err = 0.0
        if p.execution_mode == ExecutionMode.EXEC_NOISE_ESTIMATION:
            imag = np.abs(np.imag(vals))
            log_err = float(np.log2(max(imag.max() * ct.scale, 1.0)))
        return Plaintext(poly=b, fmt=COEFF, level=ct.level, scale=ct.scale,
                         slots=ct.slots, values=vals, log_error=log_err)

    # ------------------------------------------------------------------
    # level and degree alignment (reference rns-leveledshe,
    # ckksrns-leveledshe.cpp)
    # ------------------------------------------------------------------

    def _scalar_mult_raw(self, ct: Ciphertext, value: float,
                         pt_scale: float) -> Ciphertext:
        """Multiply by `value` encoded at the scale `pt_scale`: the value
        is multiplied by `value`, the tracked scale by `pt_scale`
        (reference EvalMultCoreInPlace(ct, double)). FLEXIBLE modes pick
        `pt_scale` so the product lands on a target scale exactly."""
        pt = self.MakeCKKSPackedPlaintext(
            np.full(ct.slots, value, np.complex128), level=ct.level,
            slots=ct.slots, scale=pt_scale)
        q = self.basis_at(ct.level).q
        return dataclasses.replace(
            ct, elements=tuple(mo.mul_mod(c, pt.poly, q)
                               for c in ct.elements),
            noise_deg=ct.noise_deg + 1, scale=ct.scale * pt_scale)

    def _adjust_flexible(self, a: Ciphertext, b: Ciphertext,
                         for_mult: bool = False):
        """FLEXIBLE level and degree alignment with exact scales
        (reference AdjustLevelsAndDepthInPlace, ckksrns-leveledshe.cpp:603):
        the operand behind in (level, degree) is brought to the other's by
        one scalar multiply whose encoding scale lands it on the other's
        scale."""
        def bring(x, l2, d2, target_scale):
            if x.noise_deg == 2 and x.level < l2:
                x = self.ModReduce(x)
            if x.level == l2 and x.noise_deg == d2:
                return x
            if d2 == 2:
                x = self._scalar_mult_raw(x, 1.0, target_scale / x.scale)
                if x.level < l2:
                    x = self.LevelReduce(x, l2 - x.level)
                return x
            if x.level == l2:
                return x
            ql = self.drop_factor(l2 - 1)
            x = self._scalar_mult_raw(
                x, 1.0, target_scale * float(ql) / x.scale)
            if x.level < l2 - 1:
                x = self.LevelReduce(x, l2 - 1 - x.level)
            return self.ModReduce(x)

        if a.level == b.level and a.noise_deg == b.noise_deg:
            if (not for_mult and a.noise_deg == 1
                    and abs(a.scale / b.scale - 1.0) > 1e-10):
                # scales drifted apart (e.g. a LevelReduce across composite
                # groups): raise both to one degree-2 scale with x1
                # multiplies while it fits under the remaining modulus,
                # else add as they are
                t = self.scale_at(a.level) ** 2
                logq_rem = sum(math.log2(float(q)) for q in
                               self.moduli_q[:self.size_ql(a.level)])
                if math.log2(t) + 12 < logq_rem:
                    a = self._scalar_mult_raw(a, 1.0, t / a.scale)
                    b = self._scalar_mult_raw(b, 1.0, t / b.scale)
            return a, b
        if (a.level, a.noise_deg) < (b.level, b.noise_deg):
            a = bring(a, b.level, b.noise_deg, b.scale)
        else:
            b = bring(b, a.level, a.noise_deg, a.scale)
        return a, b

    def _adjust_pair(self, a: Ciphertext, b: Ciphertext,
                     for_mult: bool = False):
        """Equalize level and noise degree before an add or a mult
        (reference AdjustLevelsAndDepth). FIXED modes: under FIXEDAUTO a
        degree-2 operand at the shallower level is rescaled, and a degree
        left lower is raised by an x1 plaintext multiply; then towers are
        dropped to align levels."""
        if self._flexible():
            return self._adjust_flexible(a, b, for_mult=for_mult)
        if a.noise_deg != b.noise_deg:
            if self._auto():
                if a.noise_deg == 2 and a.level <= b.level:
                    a = self.ModReduce(a)
                elif b.noise_deg == 2 and b.level <= a.level:
                    b = self.ModReduce(b)
            if a.noise_deg < b.noise_deg:
                a = self._eval_mult_plain(a, self._encode_like_mult(a, 1.0))
            elif b.noise_deg < a.noise_deg:
                b = self._eval_mult_plain(b, self._encode_like_mult(b, 1.0))
        if a.level < b.level:
            a = self.LevelReduce(a, b.level - a.level)
        elif b.level < a.level:
            b = self.LevelReduce(b, a.level - b.level)
        return a, b

    # ------------------------------------------------------------------
    # leveled ops
    # ------------------------------------------------------------------

    @staticmethod
    def _is_scalar(x) -> bool:
        return isinstance(x, (int, float, complex)) and not isinstance(
            x, bool)

    def EvalAdd(self, a: Ciphertext, b) -> Ciphertext:
        """a + b for a ciphertext, plaintext or scalar b."""
        if self._is_scalar(b):
            return self._eval_add_scalar(a, b)
        if isinstance(b, Plaintext):
            return self._eval_add_plain(a, b)
        a, b = self._adjust_pair(a, b)
        q = self.basis_at(a.level).q
        longer = max(a.elements, b.elements, key=len)
        both = tuple(mo.add_mod(x, y, q)
                     for x, y in zip(a.elements, b.elements))
        return dataclasses.replace(a, elements=both + longer[len(both):])

    def EvalSub(self, a: Ciphertext, b) -> Ciphertext:
        """a - b for a ciphertext, plaintext or scalar b."""
        if self._is_scalar(b):
            return self._eval_add_scalar(a, -b)
        if isinstance(b, Plaintext):
            return self._eval_add_plain(a, b, negate=True)
        a, b = self._adjust_pair(a, b)
        q = self.basis_at(a.level).q
        na = len(a.elements)
        both = tuple(mo.sub_mod(x, y, q)
                     for x, y in zip(a.elements, b.elements))
        rest = (a.elements[len(both):] if na > len(both) else
                tuple(mo.neg_mod(y, q) for y in b.elements[len(both):]))
        return dataclasses.replace(a, elements=both + rest)

    def EvalNegate(self, a: Ciphertext) -> Ciphertext:
        q = self.basis_at(a.level).q
        return dataclasses.replace(
            a, elements=tuple(mo.neg_mod(c, q) for c in a.elements))

    def _encode_like(self, ct: Ciphertext, values) -> Plaintext:
        """`values` encoded at ct's level and degree (an addend)."""
        return self.MakeCKKSPackedPlaintext(
            np.broadcast_to(np.asarray(values, np.complex128), (ct.slots,)),
            scale_deg=ct.noise_deg, level=ct.level, slots=ct.slots)

    def _encode_like_mult(self, ct: Ciphertext, values) -> Plaintext:
        """`values` encoded at ct's level and degree 1 (a factor)."""
        return self.MakeCKKSPackedPlaintext(
            np.broadcast_to(np.asarray(values, np.complex128), (ct.slots,)),
            scale_deg=1, level=ct.level, slots=ct.slots)

    def _eval_add_plain(self, ct: Ciphertext, pt: Plaintext,
                        negate: bool = False) -> Ciphertext:
        if pt.level != ct.level or pt.noise_deg != ct.noise_deg:
            pt = self.MakeCKKSPackedPlaintext(
                pt.values, scale_deg=ct.noise_deg, level=ct.level,
                slots=ct.slots)
        op = mo.sub_mod if negate else mo.add_mod
        c0 = op(ct.elements[0], pt.poly, self.basis_at(ct.level).q)
        return dataclasses.replace(ct, elements=(c0,) + ct.elements[1:])

    def _eval_add_scalar(self, ct: Ciphertext, s) -> Ciphertext:
        return self._eval_add_plain(ct, self._encode_like(ct, s))

    def _eval_mult_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        if self._auto() and ct.noise_deg == 2:
            ct = self.ModReduce(ct)
        if pt.level != ct.level:
            # the plaintext's own slot count: a diagonal may be encoded
            # wider than the ciphertext's slots
            pt = self.MakeCKKSPackedPlaintext(pt.values, scale_deg=1,
                                              level=ct.level,
                                              slots=pt.slots or ct.slots)
        q = self.basis_at(ct.level).q
        return dataclasses.replace(
            ct, elements=tuple(mo.mul_mod(c, pt.poly, q)
                               for c in ct.elements),
            noise_deg=ct.noise_deg + pt.noise_deg,
            scale=ct.scale * pt.scale)

    def _prepare_mult(self, a: Ciphertext, b: Ciphertext):
        if self._auto():
            if a.noise_deg == 2:
                a = self.ModReduce(a)
            if b.noise_deg == 2:
                b = self.ModReduce(b)
        return self._adjust_pair(a, b, for_mult=True)

    def _product_meta(self, a: Ciphertext, b: Ciphertext) -> dict:
        return dict(noise_deg=a.noise_deg + b.noise_deg,
                    scale=a.scale * b.scale)

    def EvalMultNoRelin(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """Tensor product (c0d0, c0d1+c1d0, c1d1), Karatsuba, of two
        2-element ciphertexts (the JAX package drops a third element
        without a word; here it raises NotImplementedError)."""
        self._two_elements(a, "EvalMultNoRelin")
        self._two_elements(b, "EvalMultNoRelin")
        a, b = self._prepare_mult(a, b)
        q = self.basis_at(a.level).q
        (a0, a1), (b0, b1) = a.elements, b.elements
        c0 = mo.mul_mod(a0, b0, q)
        c2 = mo.mul_mod(a1, b1, q)
        cross = mo.mul_mod(mo.add_mod(a0, a1, q), mo.add_mod(b0, b1, q), q)
        c1 = mo.sub_mod(mo.sub_mod(cross, c0, q), c2, q)
        return dataclasses.replace(a, elements=(c0, c1, c2),
                                   **self._product_meta(a, b))

    def Relinearize(self, ct: Ciphertext) -> Ciphertext:
        if len(ct.elements) == 2:
            return ct
        if len(ct.elements) != 3:
            raise NotImplementedError("relinearization beyond degree 2")
        ek = self.eval_mult_keys[ct.key_tag]
        tabs = self.hybrid_tables(self.size_ql(ct.level))
        return dataclasses.replace(ct, elements=relin_hybrid(*ct.elements,
                                                             ek, tabs))

    def EvalMult(self, a: Ciphertext, b) -> Ciphertext:
        """a * b for a ciphertext (tensor product + relinearization),
        plaintext or scalar b."""
        if self._is_scalar(b):
            return self._eval_mult_plain(a, self._encode_like_mult(a, b))
        if isinstance(b, Plaintext):
            return self._eval_mult_plain(a, b)
        if len(a.elements) != 2 or len(b.elements) != 2:
            return self.Relinearize(self.EvalMultNoRelin(a, b))
        a, b = self._prepare_mult(a, b)
        ek = self.eval_mult_keys[a.key_tag]
        tabs = self.hybrid_tables(self.size_ql(a.level))
        c0, c1 = mult_relin_hybrid(a.elements[0], a.elements[1],
                                   b.elements[0], b.elements[1], ek, tabs)
        return dataclasses.replace(a, elements=(c0, c1),
                                   **self._product_meta(a, b))

    def EvalSquare(self, a: Ciphertext) -> Ciphertext:
        return self.EvalMult(a, a)

    def EvalMultAndRelinearize(self, a: Ciphertext,
                               b: Ciphertext) -> Ciphertext:
        """Tensor product, then a full relinearization."""
        return self.Relinearize(self.EvalMultNoRelin(a, b))

    # -- the reference's InPlace / Mutable / NoCheck forms: ciphertexts are
    # immutable here, so each returns a new one
    EvalAddInPlace = EvalAddMutable = EvalAddNoCheck = EvalAdd
    EvalAddInPlaceNoCheck = EvalAddMutableInPlace = EvalAdd
    EvalSubInPlace = EvalSubMutable = EvalSubMutableInPlace = EvalSub
    EvalMultInPlace = EvalMultMutable = EvalMultMutableInPlace = EvalMult
    EvalMultNoCheck = EvalMult
    EvalMultNoRelinNoCheck = EvalMultNoRelin
    EvalNegateInPlace = EvalNegate
    EvalSquareInPlace = EvalSquareMutable = EvalSquare

    # ------------------------------------------------------------------
    # rescaling and level management (reference rns-leveledshe.cpp)
    # ------------------------------------------------------------------

    def ModReduce(self, ct: Ciphertext, levels: int | None = None
                  ) -> Ciphertext:
        """CKKS rescale: drop `levels` levels of `comp_deg` towers each,
        dividing by each tower."""
        levels = 1 if levels is None else levels
        size = self.size_ql(ct.level)
        elems = ct.elements
        scale = ct.scale
        for i in range(levels * self.comp_deg):
            basis = self.basis_q.slice(0, size - i)
            tab = self.rescale_tables(size - i)
            elems = tuple(rt.drop_last_and_scale(Poly(c, EVAL), basis,
                                                 tab).data for c in elems)
            scale /= self.moduli_q[size - i - 1]
        return dataclasses.replace(ct, elements=elems,
                                   level=ct.level + levels,
                                   noise_deg=max(1, ct.noise_deg - levels),
                                   scale=scale)

    Rescale = RescaleInPlace = ModReduceInPlace = ModReduce

    def LevelReduce(self, ct: Ciphertext, levels: int = 1) -> Ciphertext:
        """Drop towers without scaling (reference LevelReduce)."""
        size = self.size_ql(ct.level + levels)
        return dataclasses.replace(
            ct, elements=tuple(c[..., :size, :].contiguous()
                               for c in ct.elements),
            level=ct.level + levels)

    LevelReduceInPlace = LevelReduce

    def Compress(self, ct: Ciphertext, towers_left: int = 1) -> Ciphertext:
        """Reduce to about `towers_left` towers before transmission
        (reference cryptocontext.h:2581); with composite scaling the drop
        rounds down to whole levels."""
        if ct.noise_deg == 2:
            ct = self.ModReduce(ct)
        drop = (self.size_ql(ct.level) - towers_left) // self.comp_deg
        return self.LevelReduce(ct, drop) if drop > 0 else ct

    # ------------------------------------------------------------------
    # rotations (reference EvalRotate/EvalAtIndex, cryptocontext.h:2302)
    # ------------------------------------------------------------------

    def _auto_idx(self, g: int) -> torch.Tensor:
        """The EVAL gather table of sigma_g on the context's device."""
        idx = self._auto_idx_cache.get(g)
        if idx is None:
            idx = self._auto_idx_cache[g] = torch.from_numpy(
                eval_indices(self.ring_dim, g).astype(np.int64)).to(
                    self.device)
        return idx

    def _two_elements(self, ct: Ciphertext, op: str) -> None:
        if len(ct.elements) != 2:
            raise NotImplementedError(
                f"{op} of a {len(ct.elements)}-element ciphertext "
                "(relinearize first)")

    def EvalAutomorphism(self, ct: Ciphertext, g: int) -> Ciphertext:
        self._two_elements(ct, "EvalAutomorphism")
        ek = self.eval_automorphism_keys[ct.key_tag][g]
        tabs = self.hybrid_tables(self.size_ql(ct.level))
        return dataclasses.replace(ct, elements=automorph_hybrid(
            ct.elements, self._auto_idx(g), ek, tabs))

    def EvalRotate(self, ct: Ciphertext, index: int) -> Ciphertext:
        """Slot rotation: index 1 moves slot i + 1 to slot i."""
        return self.EvalAutomorphism(
            ct, rotation_automorphism_index(index, self.ring_dim))

    EvalAtIndex = EvalRotate

    def EvalConjugate(self, ct: Ciphertext) -> Ciphertext:
        return self.EvalAutomorphism(ct, conjugation_index(self.ring_dim))

    # ------------------------------------------------------------------
    # hoisted rotations (reference EvalFastRotationPrecompute /
    # EvalFastRotation, cryptocontext.h:2331-2410)
    # ------------------------------------------------------------------

    def EvalFastRotationPrecompute(self, ct: Ciphertext) -> list:
        """Digit-decompose c1 once; every EvalFastRotation shares it."""
        self._two_elements(ct, "EvalFastRotationPrecompute")
        tabs = self.hybrid_tables(self.size_ql(ct.level))
        return hybrid.eval_fast_rotation_precompute(ct.elements[1], tabs)

    def EvalFastRotation(self, ct: Ciphertext, index: int, m: int = 0,
                         digits=None) -> Ciphertext:
        """Rotation on hoisted digits (EvalRotate when there are none).
        The words may differ from EvalRotate's: see
        `hybrid.eval_fast_rotation_core`."""
        if digits is None:
            return self.EvalRotate(ct, index)
        self._two_elements(ct, "EvalFastRotation")
        g = rotation_automorphism_index(index, self.ring_dim)
        ek = self.eval_automorphism_keys[ct.key_tag][g]
        tabs = self.hybrid_tables(self.size_ql(ct.level))
        idx = self._auto_idx(g)
        d0, d1 = hybrid.eval_fast_rotation_core(digits, idx, ek, tabs)
        c0 = torch.index_select(ct.elements[0], -1, idx)
        return dataclasses.replace(
            ct, elements=(mo.add_mod(c0, d0, tabs.basis_ql.q), d1))

    # ------------------------------------------------------------------
    # generic key switching (reference KeySwitch, cryptocontext.h:1685)
    # ------------------------------------------------------------------

    def KeySwitch(self, ct: Ciphertext, ek: EvalKey) -> Ciphertext:
        """Switch a 2-element ciphertext to the key `ek` targets."""
        self._two_elements(ct, "KeySwitch")
        tabs = self.hybrid_tables(self.size_ql(ct.level))
        return dataclasses.replace(
            ct, elements=hybrid.keyswitch_core(ct.elements[1], ek, tabs,
                                               ct.elements[0]),
            key_tag=ek.key_tag)

    # ------------------------------------------------------------------
    # AdvancedSHE: many-operand trees and rotation ladders (advanced.py)
    # ------------------------------------------------------------------

    def EvalAddMany(self, cts) -> Ciphertext:
        return advanced.eval_add_many(self, cts)

    def EvalMultMany(self, cts) -> Ciphertext:
        return advanced.eval_mult_many(self, cts)

    def EvalSumKeyGen(self, sk: PrivateKey, batch_size=None) -> None:
        advanced.eval_sum_keygen(self, sk, batch_size)

    def EvalSum(self, ct: Ciphertext, batch_size=None) -> Ciphertext:
        return advanced.eval_sum(self, ct, batch_size)

    def EvalSumRowsKeyGen(self, sk: PrivateKey, row_size: int,
                          batch: int) -> None:
        advanced.eval_sum_rows_keygen(self, sk, row_size, batch)

    def EvalSumRows(self, ct: Ciphertext, row_size: int,
                    batch=None) -> Ciphertext:
        return advanced.eval_sum_rows(self, ct, row_size, batch)

    def EvalSumColsKeyGen(self, sk: PrivateKey, row_size: int) -> None:
        advanced.eval_sum_cols_keygen(self, sk, row_size)

    def EvalSumCols(self, ct: Ciphertext, row_size: int) -> Ciphertext:
        return advanced.eval_sum_cols(self, ct, row_size)

    def EvalInnerProduct(self, ct1: Ciphertext, ct2: Ciphertext,
                         batch_size=None) -> Ciphertext:
        return advanced.eval_inner_product(self, ct1, ct2, batch_size)

    def EvalLinearWSum(self, cts, weights) -> Ciphertext:
        return advanced.eval_linear_wsum(self, cts, weights)

    EvalLinearWSumMutable = EvalLinearWSum

    def EvalAddManyInPlace(self, cts) -> Ciphertext:
        return self.EvalAddMany(cts)

    def EvalMerge(self, cts) -> Ciphertext:
        return advanced.eval_merge(self, cts)

    def EvalPowers(self, ct: Ciphertext, coefficients) -> dict:
        """The power basis for EvalPolyWithPrecomp (reference
        cryptocontext.h:2716)."""
        return advanced.eval_powers(self, ct, coefficients)

    def EvalPolyWithPrecomp(self, powers: dict, coefficients) -> Ciphertext:
        return advanced.eval_poly_with_precomp(self, powers, coefficients)

    def EvalPoly(self, ct: Ciphertext, coeffs) -> Ciphertext:
        return advanced.eval_poly(self, ct, coeffs)

    EvalPolyPS = EvalPoly

    def EvalPolyLinear(self, ct: Ciphertext, coeffs) -> Ciphertext:
        return advanced.eval_poly_linear(self, ct, coeffs)

    def EvalChebyPolys(self, ct: Ciphertext, coefficients, a: float = -1.0,
                       b: float = 1.0) -> dict:
        """The Chebyshev basis for EvalChebyshevSeriesWithPrecomp
        (reference cryptocontext.h:2793)."""
        return advanced.eval_cheby_polys(self, ct, coefficients, a, b)

    def EvalChebyshevSeriesWithPrecomp(self, basis: dict,
                                       coefficients) -> Ciphertext:
        return advanced.eval_chebyshev_series_with_precomp(self, basis,
                                                           coefficients)

    def EvalChebyshevSeries(self, ct: Ciphertext, coeffs, a,
                            b) -> Ciphertext:
        return advanced.eval_chebyshev_series(self, ct, coeffs, a, b)

    def EvalChebyshevSeriesLinear(self, ct: Ciphertext, coeffs, a,
                                  b) -> Ciphertext:
        return advanced.eval_chebyshev_series_linear(self, ct, coeffs, a, b)

    def EvalChebyshevSeriesPS(self, ct: Ciphertext, coeffs, a,
                              b) -> Ciphertext:
        return advanced.eval_chebyshev_series_ps(self, ct, coeffs, a, b)

    def EvalChebyshevFunction(self, func, ct: Ciphertext, a, b,
                              degree) -> Ciphertext:
        return advanced.eval_chebyshev_function(self, func, ct, a, b,
                                                degree)

    def EvalSin(self, ct: Ciphertext, a, b, degree) -> Ciphertext:
        return advanced.eval_sin(self, ct, a, b, degree)

    def EvalCos(self, ct: Ciphertext, a, b, degree) -> Ciphertext:
        return advanced.eval_cos(self, ct, a, b, degree)

    def EvalLogistic(self, ct: Ciphertext, a, b, degree) -> Ciphertext:
        return advanced.eval_logistic(self, ct, a, b, degree)

    def EvalDivide(self, ct: Ciphertext, a, b, degree) -> Ciphertext:
        return advanced.eval_divide(self, ct, a, b, degree)


def GenCryptoContext(params: prm.CCParams, seed: int = 0,
                     device=None) -> CryptoContext:
    """(reference: gen-cryptocontext.h:88-92). `device` defaults to the
    GPU and raises when there is none."""
    return CryptoContext(params, seed=seed, device=device)
