"""CryptoContext: the user-facing FHE API (CKKS subset).

Counterpart of the CKKS part of `openfhe_tpu/pke/context.py` (reference
analog: cryptocontext.h). The context is a host object holding the bases,
the conversion tables (built lazily per level) and the key stores, all on
one device. Method names mirror the reference.

Ported: CKKS with HYBRID key switching and FIXEDMANUAL / FIXEDAUTO
scaling. Every key switch goes through `hybrid.keyswitch_core` and
EvalMult of two 2-element ciphertexts through `mult_relin_hybrid`: on a
CUDA context each is one five-kernel chain (`ks_fused.keyswitch_core_fused`
for Relinearize, KeySwitch and every automorphism, `ks_fused.
mult_relin_fused` for EvalMult), on the CPU the unfused chain, with the
same words. Rotations: automorphism keys (`eval_automorphism_keys[key_tag]
[g]`), EvalAutomorphism / EvalRotate / EvalAtIndex / EvalConjugate, the
hoisted EvalFastRotation, and the rotation ladders of `advanced.py`
(EvalSum, EvalSumRows, EvalSumCols, EvalInnerProduct). BGV/BFV, BV key
switching, the extended-basis ops (KeySwitchExt, EvalFastRotationExt,
KeySwitchDown), EvalSub / EvalNegate, plaintext and scalar ops, FLEXIBLE
and composite scaling raise NotImplementedError or are absent.

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
from openfhe_tpu_torch.pke.constants import (DecryptionNoiseMode,
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
        if params.scaling_technique not in (ScalingTechnique.FIXEDMANUAL,
                                            ScalingTechnique.FIXEDAUTO):
            raise NotImplementedError(
                f"{params.scaling_technique} is not ported yet")
        if (params.decryption_noise_mode
                == DecryptionNoiseMode.NOISE_FLOODING_DECRYPT):
            raise NotImplementedError("noise-flooding decryption")
        self.device = resolve_device(device)
        self.params = params
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
        self.moduli_q = prm.select_ckks_moduli(
            n, p.mult_depth, p.scaling_mod_size, p.first_mod_size,
            flexible=False)
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

    # ------------------------------------------------------------------
    # infrastructure
    # ------------------------------------------------------------------

    def Enable(self, feature: PKESchemeFeature) -> None:
        self._features |= feature

    def size_ql(self, level: int) -> int:
        return len(self.moduli_q) - level

    def basis_at(self, level: int) -> Basis:
        return self.basis_q.slice(0, self.size_ql(level))

    def scale_at(self, level: int) -> float:
        """Scaling factor of a depth-1 ciphertext (FIXED: 2^p at every
        level)."""
        return self.delta

    def _auto(self) -> bool:
        return self.params.scaling_technique == ScalingTechnique.FIXEDAUTO

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

    def decode_ckks(self, coeff_residues: np.ndarray, scale: float,
                    slots: int) -> np.ndarray:
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
        b = rns_pke.decrypt_core(ct.elements, sk, self.basis_at(ct.level))
        vals = self.decode_ckks(mo.to_u32(b), ct.scale, ct.slots)
        return Plaintext(poly=b, fmt=COEFF, level=ct.level, scale=ct.scale,
                         slots=ct.slots, values=vals)

    # ------------------------------------------------------------------
    # leveled ops
    # ------------------------------------------------------------------

    def _adjust_pair(self, a: Ciphertext, b: Ciphertext):
        """Equalize level and noise degree before an add or a mult
        (FIXED modes: rescale a degree-2 operand under FIXEDAUTO, drop
        towers to align levels)."""
        if a.noise_deg != b.noise_deg and self._auto():
            if a.noise_deg == 2 and a.level <= b.level:
                a = self.ModReduce(a)
            elif b.noise_deg == 2 and b.level <= a.level:
                b = self.ModReduce(b)
        if a.noise_deg != b.noise_deg:
            raise NotImplementedError(
                "operands of different noise degree (the x1 plaintext "
                "multiply is not ported yet)")
        if a.level < b.level:
            a = self.LevelReduce(a, b.level - a.level)
        elif b.level < a.level:
            b = self.LevelReduce(b, a.level - b.level)
        return a, b

    def EvalAdd(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        a, b = self._adjust_pair(a, b)
        q = self.basis_at(a.level).q
        longer = max(a.elements, b.elements, key=len)
        both = tuple(mo.add_mod(x, y, q)
                     for x, y in zip(a.elements, b.elements))
        return dataclasses.replace(a, elements=both + longer[len(both):])

    def _prepare_mult(self, a: Ciphertext, b: Ciphertext):
        if self._auto():
            if a.noise_deg == 2:
                a = self.ModReduce(a)
            if b.noise_deg == 2:
                b = self.ModReduce(b)
        return self._adjust_pair(a, b)

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

    def EvalMult(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """Tensor product + relinearization of two ciphertexts."""
        if len(a.elements) != 2 or len(b.elements) != 2:
            return self.Relinearize(self.EvalMultNoRelin(a, b))
        a, b = self._prepare_mult(a, b)
        ek = self.eval_mult_keys[a.key_tag]
        tabs = self.hybrid_tables(self.size_ql(a.level))
        c0, c1 = mult_relin_hybrid(a.elements[0], a.elements[1],
                                   b.elements[0], b.elements[1], ek, tabs)
        return dataclasses.replace(a, elements=(c0, c1),
                                   **self._product_meta(a, b))

    def ModReduce(self, ct: Ciphertext, levels: int | None = None
                  ) -> Ciphertext:
        """CKKS rescale: drop `levels` towers, dividing by each."""
        levels = 1 if levels is None else levels
        size = self.size_ql(ct.level)
        elems = ct.elements
        scale = ct.scale
        for i in range(levels):
            basis = self.basis_q.slice(0, size - i)
            tab = self.rescale_tables(size - i)
            elems = tuple(rt.drop_last_and_scale(Poly(c, EVAL), basis,
                                                 tab).data for c in elems)
            scale /= self.moduli_q[size - i - 1]
        return dataclasses.replace(ct, elements=elems,
                                   level=ct.level + levels,
                                   noise_deg=max(1, ct.noise_deg - levels),
                                   scale=scale)

    Rescale = ModReduce

    def LevelReduce(self, ct: Ciphertext, levels: int = 1) -> Ciphertext:
        """Drop towers without scaling (reference LevelReduce)."""
        size = self.size_ql(ct.level + levels)
        return dataclasses.replace(
            ct, elements=tuple(c[..., :size, :].contiguous()
                               for c in ct.elements),
            level=ct.level + levels)

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


def GenCryptoContext(params: prm.CCParams, seed: int = 0,
                     device=None) -> CryptoContext:
    """(reference: gen-cryptocontext.h:88-92). `device` defaults to the
    GPU and raises when there is none."""
    return CryptoContext(params, seed=seed, device=device)
