"""CryptoContext: the user-facing FHE API.

Counterpart of `openfhe_tpu/pke/context.py` (reference
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

The integer schemes: BGV (`schemes/bgv.py`: its chain, ModReduce by
`bgv_drops_per_level` towers with the message factor in `scale_int`, the
factor's alignment of two operands) and BFV (`schemes/bfv.py`: the exact
RNS tensor product under every MultiplicationTechnique, STANDARD and
EXTENDED encryption), the packed, coefficient and string encodings
(`encoding/packed.py`), and BV key switching (`keyswitch/bv.py`) beside
HYBRID for every scheme. BGV's noise scale t reaches the keys, the
encryptions and every key switch's tables; its EvalMult runs the fused
mult chain with t. The extended-basis family: KeySwitchExt,
EvalFastRotationExt, EvalAddExt / EvalSubExt, KeySwitchDown and
KeySwitchDownFirstElement, and SparseKeyGen.

CKKS bootstrapping (`fhe/ckks_bootstrap.py`, `fhe/fft_transform.py`):
EvalBootstrapSetup / Precompute / KeyGen, GetBootstrapDepth,
SetCKKSBootCorrectionFactor, EvalBootstrap (one round and Meta-BTS's
two) and EvalBootstrapStCFirst, with the diagonals' encodings cached per
context (`_cached_plaintext`); functional bootstrapping (`fhe/fbt.py`
over the RLWE schemelet of `schemelet.py`): EvalFBTSetup / KeyGen,
EvalFBT(NoDecoding), EvalMVBPrecompute, EvalMVB(NoDecoding) and
EvalHomDecoding. CKKS <-> FHEW scheme switching (`schemeswitch.py`):
EvalCKKStoFHEWSetup / KeyGen / Precompute, EvalCKKStoFHEW,
EvalFHEWtoCKKSSetup / KeyGen, EvalFHEWtoCKKS, EvalSchemeSwitchingSetup /
KeyGen, EvalCompareSwitchPrecompute, EvalCompareSchemeSwitching,
EvalMin / EvalMaxSchemeSwitching (and their Alt names), Get /
SetBinCCForSchemeSwitch and Get / SetSwkFC; the inner BinFHE context sits
on this context's device. The key stores: EvalMultKeysGen, InsertEvalMultKey /
InsertEvalSumKey, the Clear* methods (this context's stores only) and
SetPrivateKey / GetPrivateKey; JitPipeline returns its function, run
eagerly.

The protocols (`multiparty.py`, `pre.py`): MultipartyKeyGen,
MultipartyDecryptLead / Main / Fusion (NOISE_FLOODING_MULTIPARTY's
extra-limb mask for BGV and BFV, whose chains carry its 128 extra bits),
MultiAddPubKeys, the joint eval-key protocol (MultiKeySwitchGen,
MultiAddEvalKeys, MultiMultEvalKey, MultiAddEvalMultKeys,
MultiEvalAutomorphismKeyGen, MultiAddAutomorphismKeys: every key with its
Shoup companions, so joint keys run the fused chains), ShareKeys /
RecoverSharedKey, interactive bootstrapping (IntBootAdjustScale /
Decrypt / Encrypt / Add and IntMPBootAdjustScale / RandomElementGen /
Decrypt / Add / Encrypt) and ReKeyGen / ReEncrypt under INDCPA,
FIXED_NOISE_HRA and NOISE_FLOODING_HRA (HYBRID only: ReEncrypt is one
general fused chain with c0 as its addend). Serialization
(`utils/serialization.py`, the JAX package's format byte for byte):
Serialize / DeserializeEvalMultKey, EvalAutomorphismKey and EvalSumKey.
EvalHermiteTrigSeries (`math/hermite.py`). Ciphertexts of three or more
elements are refused where the JAX package reads two and drops the
rest.

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
from openfhe_tpu_torch.math.hermite import get_hermite_trig_coefficients
from openfhe_tpu_torch.pke import advanced, multiparty as mp, pre
from openfhe_tpu_torch.pke import schemeswitch as ssw
from openfhe_tpu_torch.pke import parameters as prm
from openfhe_tpu_torch.pke.ciphertext import Ciphertext, Plaintext
from openfhe_tpu_torch.math import sampling
from openfhe_tpu_torch.pke.constants import (DecryptionNoiseMode,
                                             EncryptionTechnique,
                                             ExecutionMode,
                                             KeySwitchTechnique,
                                             PKESchemeFeature,
                                             PlaintextEncodings,
                                             ScalingTechnique, Scheme,
                                             SecretKeyDist)
from openfhe_tpu_torch.pke.encoding import ckks_packed
from openfhe_tpu_torch.pke.encoding.packed import coef_encode, string_encode
from openfhe_tpu_torch.pke.fhe import ckks_bootstrap, fbt
from openfhe_tpu_torch.pke.keys import EvalKey, KeyPair, PrivateKey, PublicKey
from openfhe_tpu_torch.pke.keyswitch import bv, hybrid, ks_fused
from openfhe_tpu_torch.pke.schemes import bfv, bgv, rns_pke
from openfhe_tpu_torch.utils import serialization as ser


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
    return hybrid.keyswitch_core(c2, ek, tabs, c0, c1)


class CryptoContext:
    """One instantiated scheme (parameters frozen, tables cached)."""

    def __init__(self, params: prm.CCParams, seed: int = 0, device=None):
        params.validate()
        self.device = resolve_device(device)
        self.params = params
        self.scheme = params.scheme
        self._features = PKESchemeFeature(0)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._key_counter = 0
        self.comp_deg = 1
        self.noise_scale_int = 1
        if self.scheme == Scheme.CKKSRNS_SCHEME:
            self._init_ckks()
        elif self.scheme == Scheme.BGVRNS_SCHEME:
            bgv.init_context(self)
        else:
            bfv.init_context(self)
        self._hybrid_cache: dict = {}
        self._bv_cache: dict = {}
        self._rescale_cache: dict = {}
        self.eval_mult_keys: dict = {}
        self.eval_automorphism_keys: dict = {}   # key_tag -> {g: EvalKey}
        self.eval_sum_keys: dict = {}            # key_tag -> True
        self._auto_idx_cache: dict = {}
        # the bootstrap's state: its precompute per slot count, the
        # composite ModRaise's tables and the encoded diagonals
        self._boot_precom: dict = {}
        self._modraise_cache: dict = {}
        self._pt_cache: dict = {}
        self._schswch: ssw.SchemeSwitchState | None = None
        # NOISE_FLOODING_MULTIPARTY's exact Q' -> Q switch tables
        self._flood_cache: dict = {}

    # ------------------------------------------------------------------
    # parameter generation
    # ------------------------------------------------------------------

    def _init_common(self, moduli_q) -> None:
        """The chain's bases on the device: Q, and P for HYBRID (BV has no
        auxiliary towers: basis_qp is Q). The security check covers
        log QP."""
        p = self.params
        n = self.ring_dim = p.ring_dim
        self.moduli_q = list(moduli_q)
        self.moduli_p = (prm.select_aux_moduli(n, self.moduli_q,
                                               p.num_large_digits,
                                               p.aux_mod_size)
                         if p.ks_technique == KeySwitchTechnique.HYBRID
                         else [])
        log_qp = sum(math.log2(q) for q in self.moduli_q + self.moduli_p)
        prm.validate_security(p, n, log_qp)
        dev = self.device
        self.basis_q = make_basis(self.moduli_q, n, device=dev)
        self.big_p = math.prod(self.moduli_p)
        if not self.moduli_p:
            self.basis_p = None
            self.basis_qp = self.basis_q
            self.p_modq = self.p_modq_sh = None
            return
        self.basis_p = make_basis(self.moduli_p, n, device=dev)
        self.basis_qp = self.basis_q.concat(self.basis_p)
        pm = [self.big_p % q for q in self.moduli_q] + [0] * len(self.moduli_p)
        self.p_modq, self.p_modq_sh = mo.shoup_pair(
            pm, self.moduli_q + self.moduli_p, dev)

    def _init_ckks(self):
        p = self.params
        if p.ring_dim == 0:
            est_log = p.first_mod_size + p.mult_depth * p.scaling_mod_size
            est_log += est_log / max(1, p.num_large_digits)  # + logP
            p.ring_dim = prm.derive_ring_dim(p, est_log)
        n = p.ring_dim
        self.comp_deg = p.composite_degree if self._composite() else 1
        if self.comp_deg > 1:
            moduli = prm.select_ckks_moduli_composite(
                n, p.mult_depth, p.scaling_mod_size, p.first_mod_size,
                self.comp_deg)
        else:
            moduli = prm.select_ckks_moduli(
                n, p.mult_depth, p.scaling_mod_size, p.first_mod_size,
                flexible=self._flexible(),
                ext_mod_size=(prm.DEFAULT_EXTRA_MOD_SIZE
                              if self._flexible_ext() else 0))
        self._init_common(moduli)
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

    def is_enabled(self, feature: PKESchemeFeature) -> bool:
        return bool(self._features & feature)

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

    def SetCKKSBootCorrectionFactor(self, factor: int) -> None:
        """The bootstrap correction factor for the next Setup (reference
        SetCKKSBootCorrectionFactor)."""
        self._boot_correction_override = int(factor)

    def GetCKKSDataType(self):
        return self.params.ckks_data_type

    # the eval-key maps' (de)serialization under the reference's names;
    # deserialized keys land on this context's device with companions
    def SerializeEvalMultKey(self, sertype=None) -> str:
        return ser.serialize_eval_mult_keys(self)

    def DeserializeEvalMultKey(self, data) -> None:
        ser.deserialize_eval_mult_keys(self, data)

    def SerializeEvalAutomorphismKey(self, sertype=None) -> str:
        return ser.serialize_eval_automorphism_keys(self)

    def DeserializeEvalAutomorphismKey(self, data) -> None:
        ser.deserialize_eval_automorphism_keys(self, data)

    SerializeEvalSumKey = SerializeEvalAutomorphismKey
    DeserializeEvalSumKey = DeserializeEvalAutomorphismKey

    def GetAllEvalMultKeys(self) -> dict:
        return self.eval_mult_keys

    def GetEvalMultKeyVector(self, key_tag: str) -> list:
        return [self.eval_mult_keys[key_tag]]

    def size_ql(self, level: int) -> int:
        return len(self.moduli_q) - self.comp_deg * level

    def basis_at(self, level: int) -> Basis:
        return self.basis_q.slice(0, self.size_ql(level))

    def basis_at_size(self, size_ql: int) -> Basis:
        return self.basis_q.slice(0, size_ql)

    def scale_at(self, level: int) -> float:
        """Scaling factor of a depth-1 ciphertext at `level` (CKKS; the
        integer schemes' is 1)."""
        if self.scheme == Scheme.CKKSRNS_SCHEME:
            return self.scf_real[level]
        return self.delta

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
                self.params.num_large_digits, ns_int=self.noise_scale_int)
        return self._hybrid_cache[size_ql]

    def bv_tables(self, size_ql: int) -> bv.BVTables:
        if size_ql not in self._bv_cache:
            self._bv_cache[size_ql] = bv.make_bv_tables(self.basis_q,
                                                        size_ql)
        return self._bv_cache[size_ql]

    def _hybrid(self) -> bool:
        return self.params.ks_technique == KeySwitchTechnique.HYBRID

    def _keyswitch_core(self, c: torch.Tensor, ek: EvalKey, size_ql: int,
                        add0: torch.Tensor | None = None,
                        add1: torch.Tensor | None = None):
        """(d0 + add0, d1 + add1) over Q_l: the key switch of c under the
        configured technique (reference KeySwitchBV / KeySwitchHYBRID),
        each plus its addend where one is given (HYBRID's fused chain adds
        it in its last kernel)."""
        if self._hybrid():
            return hybrid.keyswitch_core(c, ek, self.hybrid_tables(size_ql),
                                         add0, add1)
        w = self.params.digit_size
        if w:
            d = bv.keyswitch_core_digits(
                c, ek, self.basis_q.slice(0, size_ql), w,
                bv._digit_count(self.basis_q, len(self.moduli_q), w))
        else:
            d = bv.keyswitch_core(c, ek, self.bv_tables(size_ql))
        q = self.basis_q.slice(0, size_ql).q
        return tuple(x if a is None else mo.add_mod(a, x, q)
                     for x, a in zip(d, (add0, add1)))

    def rescale_tables(self, size_ql: int) -> rt.DropScaleTables:
        if size_ql not in self._rescale_cache:
            self._rescale_cache[size_ql] = rt.make_drop_scale_tables(
                tuple(self.moduli_q[:size_ql]), self.device)
        return self._rescale_cache[size_ql]

    # ------------------------------------------------------------------
    # key generation
    # ------------------------------------------------------------------

    def KeyGen(self) -> KeyPair:
        return self._keygen(self.params.secret_key_dist)

    def SparseKeyGen(self) -> KeyPair:
        """A key pair with a sparse ternary secret of Hamming weight 192
        (reference SparseKeyGen, cryptocontext.h:1238)."""
        return self._keygen(SecretKeyDist.SPARSE_TERNARY)

    def _keygen(self, secret_key_dist) -> KeyPair:
        self._key_counter += 1
        return rns_pke.keygen(self._gen, self.basis_qp,
                              f"key-{self._key_counter}", secret_key_dist,
                              self.params.standard_deviation,
                              ns_int=self.noise_scale_int)

    def KeySwitchGen(self, old_key: PrivateKey,
                     new_key: PrivateKey) -> EvalKey:
        if not self._hybrid():
            return bv.keyswitch_gen(self._gen, old_key, new_key,
                                    self.basis_q, len(self.moduli_q),
                                    ns_int=self.noise_scale_int,
                                    digit_size=self.params.digit_size)
        return hybrid.keyswitch_gen(
            self._gen, old_key, new_key, self.basis_qp, len(self.moduli_q),
            self.params.num_large_digits, self.p_modq, self.p_modq_sh,
            ns_int=self.noise_scale_int)

    def EvalMultKeyGen(self, sk: PrivateKey) -> None:
        """Relinearization key: s^2 -> s (reference cryptocontext.h:1764)."""
        s_sq = mo.mul_mod(sk.s_qp, sk.s_qp, self.basis_qp.q)
        sk2 = PrivateKey(s_qp=s_sq, key_tag=sk.key_tag)
        self.eval_mult_keys[sk.key_tag] = self.KeySwitchGen(sk2, sk)

    def EvalMultKeysGen(self, sk: PrivateKey) -> None:
        self.EvalMultKeyGen(sk)

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

    def InsertEvalMultKey(self, ek: EvalKey, key_tag: str | None = None
                          ) -> None:
        self.eval_mult_keys[key_tag or ek.key_tag] = ek

    def InsertEvalSumKey(self, key_map: dict, key_tag: str) -> None:
        """Sum keys are automorphism keys (reference InsertEvalSumKey)."""
        self.InsertEvalAutomorphismKey(key_map, key_tag)

    # the key stores (the reference's static maps, cryptocontext.h:243-245)
    # belong to this context: Clear* empties this context's stores only
    def ClearEvalMultKeys(self, key_tag: str | None = None) -> None:
        if key_tag is None:
            self.eval_mult_keys.clear()
        else:
            self.eval_mult_keys.pop(key_tag, None)

    def ClearEvalAutomorphismKeys(self, key_tag: str | None = None) -> None:
        if key_tag is None:
            self.eval_automorphism_keys.clear()
        else:
            self.eval_automorphism_keys.pop(key_tag, None)

    ClearEvalSumKeys = ClearEvalAutomorphismKeys

    def ClearStaticMapsAndVectors(self) -> None:
        self.ClearEvalMultKeys()
        self.ClearEvalAutomorphismKeys()
        self.eval_sum_keys.clear()

    def SetPrivateKey(self, sk: PrivateKey) -> None:
        """Keep a secret key in the context for noise inspection
        (reference cryptocontext.h:469-482, always available here)."""
        self._debug_private_key = sk

    def GetPrivateKey(self) -> PrivateKey | None:
        return getattr(self, "_debug_private_key", None)

    # ------------------------------------------------------------------
    # encoding
    # ------------------------------------------------------------------

    def MakeCKKSPackedPlaintext(self, values, scale_deg: int = 1,
                                level: int = 0, slots: int | None = None,
                                scale: float | None = None) -> Plaintext:
        slots = slots or min(self.slots, self.ring_dim // 2)
        if (scale is None and level == 0 and scale_deg == 1
                and self.scheme == Scheme.CKKSRNS_SCHEME
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

    def _cached_plaintext(self, values, level: int, slots: int,
                          scale_deg: int = 1) -> Plaintext:
        """The CKKS encoding of a long-lived array (the bootstrap's
        diagonal tables), made once per context, level, slot count and
        degree. Keyed by the array's identity as in the JAX package; an
        entry also holds the array, so its id cannot pass to another
        array while the entry lives, and an entry made for another array
        is never returned."""
        key = (id(values), level, slots, scale_deg)
        hit = self._pt_cache.get(key)
        if hit is None or hit[0] is not values:
            hit = self._pt_cache[key] = (values, self.MakeCKKSPackedPlaintext(
                values, scale_deg=scale_deg, level=level, slots=slots))
        return hit[1]

    def MakePackedPlaintext(self, values, noise_deg: int = 1,
                            level: int = 0) -> Plaintext:
        """Integer SIMD packing (reference MakePackedPlaintext)."""
        if self.scheme == Scheme.BGVRNS_SCHEME:
            return bgv.make_packed_plaintext(self, values, level=level,
                                             noise_deg=noise_deg)
        if self.scheme == Scheme.BFVRNS_SCHEME:
            return bfv.make_packed_plaintext(self, values)
        raise ValueError("PackedPlaintext requires BGV/BFV")

    def MakePlaintext(self, encoding, values) -> Plaintext:
        """The factory over PlaintextEncodings (reference MakePlaintext,
        plaintextfactory.h:136)."""
        make = {PlaintextEncodings.PACKED_ENCODING: self.MakePackedPlaintext,
                PlaintextEncodings.CKKS_PACKED_ENCODING:
                    self.MakeCKKSPackedPlaintext,
                PlaintextEncodings.COEF_PACKED_ENCODING:
                    self.MakeCoefPackedPlaintext,
                PlaintextEncodings.STRING_ENCODING:
                    self.MakeStringPlaintext}.get(encoding)
        if make is None:
            raise ValueError(f"unknown plaintext encoding {encoding}")
        return make(values)

    def _full_level_plaintext(self, coeffs, encoding: str,
                              values) -> Plaintext:
        res = crt.to_residues_host(coeffs, tuple(self.moduli_q))
        poly = ntt_fwd(mo.u32_tensor(res, self.device), self.basis_q)
        return Plaintext(poly=poly, fmt=EVAL, level=0, slots=self.ring_dim,
                         encoding=encoding, values=values)

    def MakeCoefPackedPlaintext(self, values) -> Plaintext:
        """Coefficient packing (reference MakeCoefPackedPlaintext)."""
        t = self.plaintext_modulus
        coeffs = coef_encode(values, t, self.ring_dim)
        return self._full_level_plaintext(
            np.where(coeffs > t // 2, coeffs - t, coeffs), "COEF_PACKED",
            np.asarray(values))

    def MakeStringPlaintext(self, s: str) -> Plaintext:
        """String encoding (reference MakeStringPlaintext): the bytes as
        coefficients."""
        return self._full_level_plaintext(
            string_encode(s, self.plaintext_modulus, self.ring_dim),
            "STRING", s)

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
        """Encrypt under a public key (or key pair) or a secret key. BFV
        scales the message by Delta = floor(Q / t), or encrypts over Q r
        under EncryptionTechnique EXTENDED; BGV's errors carry t."""
        if (self.scheme == Scheme.BFVRNS_SCHEME
                and self.params.encryption_technique
                == EncryptionTechnique.EXTENDED):
            return bfv.encrypt_extended(self, key, plaintext)
        basis = self.basis_at(plaintext.level)
        ns = self.noise_scale_int
        if isinstance(key, KeyPair):
            key = key.public_key
        pt_poly = plaintext.poly
        if self.scheme == Scheme.BFVRNS_SCHEME:
            pt_poly = bfv.scale_plaintext_for_add(self, pt_poly)
        if isinstance(key, PublicKey):
            c0, c1 = rns_pke.encrypt_zero_pk(self._gen, key, basis,
                                             self.params.secret_key_dist,
                                             ns_int=ns)
        else:
            c0, c1 = rns_pke.encrypt_zero_sk(self._gen, key, basis,
                                             ns_int=ns)
        c0 = mo.add_mod(c0, pt_poly, basis.q)
        return Ciphertext(elements=(c0, c1), level=plaintext.level,
                          noise_deg=plaintext.noise_deg,
                          scale=plaintext.scale, slots=plaintext.slots,
                          key_tag=key.key_tag, encoding=plaintext.encoding,
                          scale_int=plaintext.scale_int)

    def Decrypt(self, sk: PrivateKey, ct: Ciphertext) -> Plaintext:
        """Decrypt and decode (BGV and BFV: exact integers mod t, the
        scheme's tail). CKKS: with NOISE_FLOODING_DECRYPT in
        EXEC_EVALUATION and a noise estimate, Gaussian noise of sigma
        2^noise_estimate (at most 2^30) is added to the coefficients first
        (reference ckks-noise-flooding.cpp), sampled in int64 so the +-6
        sigma clip cannot wrap. Under EXEC_NOISE_ESTIMATION the largest
        imaginary part of a real computation estimates the noise
        (`log_error`, reference GetLogError)."""
        p = self.params
        basis = self.basis_at(ct.level)
        b = rns_pke.decrypt_core(ct.elements, sk, basis)
        if self.scheme == Scheme.BGVRNS_SCHEME:
            return bgv.decrypt_tail(self, b, ct)
        if self.scheme == Scheme.BFVRNS_SCHEME:
            return bfv.decrypt_tail(self, b, ct)
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

    def _eval_times_int(self, ct: Ciphertext, k: int) -> Ciphertext:
        """Every element times the integer k (mod each q_i), BGV's
        scale-factor correction (reference EvalMultCoreInPlace(ct,
        scalar), bgvrns-leveledshe.cpp), by the centred representative of
        k mod t, which limits the noise."""
        t = self.plaintext_modulus
        k = k % t
        kc = k - t if k > t // 2 else k
        basis = self.basis_at(ct.level)
        c, c_sh = mo.shoup_pair([kc % q for q in basis.moduli],
                                basis.moduli, self.device)
        return dataclasses.replace(
            ct, elements=tuple(mo.mul_mod_shoup(e, c, c_sh, basis.q)
                               for e in ct.elements),
            scale_int=(ct.scale_int * k) % t)

    def _adjust_pair_bgv(self, a: Ciphertext, b: Ciphertext):
        """BGV's AdjustLevelsAndDepth (bgvrns-leveledshe.cpp:84-225): tower
        counts aligned by LevelReduce (the invariant m + t e is far below
        every Q_l), then the integer scale factors by a correction
        multiply; the noise degree is bookkeeping only."""
        if a.level < b.level:
            a = self.LevelReduce(a, b.level - a.level)
        elif b.level < a.level:
            b = self.LevelReduce(b, a.level - b.level)
        t = self.plaintext_modulus
        if a.scale_int % t != b.scale_int % t:
            a = self._eval_times_int(
                a, (b.scale_int * pow(a.scale_int % t, -1, t)) % t)
        deg = max(a.noise_deg, b.noise_deg)
        return (dataclasses.replace(a, noise_deg=deg),
                dataclasses.replace(b, noise_deg=deg))

    def _adjust_pair(self, a: Ciphertext, b: Ciphertext,
                     for_mult: bool = False):
        """Equalize level and noise degree before an add or a mult
        (reference AdjustLevelsAndDepth). FIXED modes: under FIXEDAUTO a
        degree-2 operand at the shallower level is rescaled, and a degree
        left lower is raised by an x1 plaintext multiply; then towers are
        dropped to align levels. BGV aligns its scale factors
        (`_adjust_pair_bgv`); BFV, scale-invariant, only its towers."""
        if self.scheme == Scheme.BGVRNS_SCHEME:
            return self._adjust_pair_bgv(a, b)
        if self.scheme == Scheme.BFVRNS_SCHEME:
            if a.level < b.level:
                a = self.LevelReduce(a, b.level - a.level)
            elif b.level < a.level:
                b = self.LevelReduce(b, a.level - b.level)
            deg = max(a.noise_deg, b.noise_deg)
            return (dataclasses.replace(a, noise_deg=deg),
                    dataclasses.replace(b, noise_deg=deg))
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
        if self.scheme != Scheme.CKKSRNS_SCHEME:
            return self.MakePackedPlaintext(
                np.broadcast_to(np.asarray(values, np.int64), (ct.slots,)),
                level=ct.level)
        return self.MakeCKKSPackedPlaintext(
            np.broadcast_to(np.asarray(values, np.complex128), (ct.slots,)),
            scale_deg=ct.noise_deg, level=ct.level, slots=ct.slots)

    def _encode_like_mult(self, ct: Ciphertext, values) -> Plaintext:
        """`values` encoded at ct's level and degree 1 (a factor; BGV's
        without the level's message factor)."""
        if self.scheme == Scheme.BGVRNS_SCHEME:
            return bgv.make_packed_plaintext(
                self, np.broadcast_to(np.asarray(values, np.int64),
                                      (self.ring_dim,)),
                level=ct.level, apply_factor=False)
        if self.scheme == Scheme.BFVRNS_SCHEME:
            return self.MakePackedPlaintext(
                np.broadcast_to(np.asarray(values, np.int64),
                                (self.ring_dim,)))
        return self.MakeCKKSPackedPlaintext(
            np.broadcast_to(np.asarray(values, np.complex128), (ct.slots,)),
            scale_deg=1, level=ct.level, slots=ct.slots)

    def _eval_add_plain(self, ct: Ciphertext, pt: Plaintext,
                        negate: bool = False) -> Ciphertext:
        ckks = self.scheme == Scheme.CKKSRNS_SCHEME
        if pt.level != ct.level or (ckks and pt.noise_deg != ct.noise_deg):
            pt = (self.MakeCKKSPackedPlaintext(
                pt.values, scale_deg=ct.noise_deg, level=ct.level,
                slots=ct.slots) if ckks else
                self.MakePackedPlaintext(pt.values, level=ct.level))
        pt_poly = pt.poly
        if self.scheme == Scheme.BFVRNS_SCHEME:
            pt_poly = bfv.scale_plaintext_for_add(self, pt_poly)
        op = mo.sub_mod if negate else mo.add_mod
        c0 = op(ct.elements[0], pt_poly, self.basis_at(ct.level).q)
        return dataclasses.replace(ct, elements=(c0,) + ct.elements[1:])

    def _eval_add_scalar(self, ct: Ciphertext, s) -> Ciphertext:
        return self._eval_add_plain(ct, self._encode_like(ct, s))

    def _eval_mult_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        ckks = self.scheme == Scheme.CKKSRNS_SCHEME
        if ckks and self._auto() and ct.noise_deg == 2:
            ct = self.ModReduce(ct)
        if pt.level != ct.level and self.scheme != Scheme.BFVRNS_SCHEME:
            # the plaintext's own slot count: a diagonal may be encoded
            # wider than the ciphertext's slots
            pt = (self.MakeCKKSPackedPlaintext(pt.values, scale_deg=1,
                                               level=ct.level,
                                               slots=pt.slots or ct.slots)
                  if ckks else self._encode_like_mult(ct, pt.values))
        q = self.basis_at(ct.level).q
        return dataclasses.replace(
            ct, elements=tuple(mo.mul_mod(c, pt.poly, q)
                               for c in ct.elements),
            noise_deg=ct.noise_deg + pt.noise_deg,
            scale=ct.scale * pt.scale,
            scale_int=ct.scale_int * pt.scale_int)

    def _prepare_mult(self, a: Ciphertext, b: Ciphertext):
        if self._auto():
            if a.noise_deg == 2:
                a = self.ModReduce(a)
            if b.noise_deg == 2:
                b = self.ModReduce(b)
        return self._adjust_pair(a, b, for_mult=True)

    def _product_meta(self, a: Ciphertext, b: Ciphertext) -> dict:
        return dict(noise_deg=a.noise_deg + b.noise_deg,
                    scale=a.scale * b.scale,
                    scale_int=a.scale_int * b.scale_int)

    def EvalMultNoRelin(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """Tensor product (c0d0, c0d1+c1d0, c1d1), Karatsuba, of two
        2-element ciphertexts (the JAX package drops a third element
        without a word; here it raises NotImplementedError); BFV's exact
        RNS tensor product (`bfv.eval_mult_no_relin`)."""
        self._two_elements(a, "EvalMultNoRelin")
        self._two_elements(b, "EvalMultNoRelin")
        if self.scheme == Scheme.BFVRNS_SCHEME:
            return bfv.eval_mult_no_relin(self, a, b)
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
        e0, e1, e2 = ct.elements
        return dataclasses.replace(ct, elements=self._keyswitch_core(
            e2, ek, self.size_ql(ct.level), e0, e1))

    def EvalMult(self, a: Ciphertext, b) -> Ciphertext:
        """a * b for a ciphertext (tensor product + relinearization),
        plaintext or scalar b."""
        if self._is_scalar(b):
            return self._eval_mult_plain(a, self._encode_like_mult(a, b))
        if isinstance(b, Plaintext):
            return self._eval_mult_plain(a, b)
        if (len(a.elements) != 2 or len(b.elements) != 2
                or not self._hybrid()
                or self.scheme == Scheme.BFVRNS_SCHEME):
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
        dividing by each tower. BGV: `bgv.mod_reduce`, `levels` towers
        (one multiplicative level when None). BFV has none."""
        if self.scheme == Scheme.BGVRNS_SCHEME:
            return bgv.mod_reduce(self, ct, levels)
        if self.scheme == Scheme.BFVRNS_SCHEME:
            raise ValueError("ModReduce is not applicable to BFV")
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
        """sigma_g of a 2-element ciphertext, as the JAX package's
        `_k_automorph_hybrid`: both elements gathered with the EVAL table
        of g, the second key-switched from s(X^g) back to s, its first
        half added to the first (inside the fused chain's last kernel)."""
        self._two_elements(ct, "EvalAutomorphism")
        ek = self.eval_automorphism_keys[ct.key_tag][g]
        idx = self._auto_idx(g)
        rot = [torch.index_select(c, -1, idx) for c in ct.elements]
        return dataclasses.replace(ct, elements=self._keyswitch_core(
            rot[1], ek, self.size_ql(ct.level), rot[0]))

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

    def EvalFastRotationPrecompute(self, ct: Ciphertext) -> list | None:
        """Digit-decompose c1 once; every EvalFastRotation shares it
        (HYBRID only: None under BV, whose rotations then run
        EvalRotate)."""
        self._two_elements(ct, "EvalFastRotationPrecompute")
        if not self._hybrid():
            return None
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
        return dataclasses.replace(
            ct, elements=self._keyswitch_core(ct.elements[1], ek,
                                              self.size_ql(ct.level),
                                              ct.elements[0]),
            key_tag=ek.key_tag)

    KeySwitchInPlace = KeySwitch

    # ------------------------------------------------------------------
    # the extended basis Q_l*P (reference KeySwitchExt / KeySwitchDown /
    # EvalFastRotationExt, cryptocontext.h:1680-2440): a ladder of
    # hoisted rotations summed before one ApproxModDown. An extended
    # ciphertext keeps its level and carries "ext_basis" True in its
    # metadata; its elements have size_ql + kP towers.
    # ------------------------------------------------------------------

    def KeySwitchExt(self, ct: Ciphertext,
                     add_first: bool = True) -> Ciphertext:
        """Every element raised to Q_l*P (times P); with add_first False
        element 0 is left zero, to be added back after
        KeySwitchDownFirstElement."""
        tabs = self.hybrid_tables(self.size_ql(ct.level))
        elems = [hybrid.raise_c0_ext(c, self.p_modq, self.p_modq_sh, tabs)
                 for c in ct.elements]
        if not add_first:
            elems[0] = torch.zeros_like(elems[0])
        return dataclasses.replace(ct, elements=tuple(elems)
                                   ).SetMetadataByKey("ext_basis", True)

    def EvalFastRotationExt(self, ct: Ciphertext, index: int, digits,
                            add_first: bool = True) -> Ciphertext:
        """A hoisted rotation left in the extended basis (reference
        EvalFastRotationExt, cryptocontext.h:2412): sum many with
        EvalAddExt, then one KeySwitchDown."""
        self._two_elements(ct, "EvalFastRotationExt")
        g = rotation_automorphism_index(index, self.ring_dim)
        ek = self.eval_automorphism_keys[ct.key_tag][g]
        tabs = self.hybrid_tables(self.size_ql(ct.level))
        idx = self._auto_idx(g)
        e0, e1 = hybrid.eval_fast_rotation_core_ext(digits, idx, ek, tabs)
        if add_first:
            c0 = torch.index_select(ct.elements[0], -1, idx)
            e0 = mo.add_mod(e0, hybrid.raise_c0_ext(
                c0, self.p_modq, self.p_modq_sh, tabs), tabs.basis_qlp.q)
        return dataclasses.replace(ct, elements=(e0, e1)).SetMetadataByKey(
            "ext_basis", True)

    def EvalAddExt(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """The elementwise sum of two extended ciphertexts (reference
        EvalAddExt)."""
        q = self.hybrid_tables(self.size_ql(a.level)).basis_qlp.q
        return dataclasses.replace(a, elements=tuple(
            mo.add_mod(x, y, q) for x, y in zip(a.elements, b.elements)))

    def EvalSubExt(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        q = self.hybrid_tables(self.size_ql(a.level)).basis_qlp.q
        return dataclasses.replace(a, elements=tuple(
            mo.sub_mod(x, y, q) for x, y in zip(a.elements, b.elements)))

    def KeySwitchDown(self, ct: Ciphertext) -> Ciphertext:
        """ApproxModDown of an extended ciphertext back to Q_l (reference
        KeySwitchDown)."""
        tabs = self.hybrid_tables(self.size_ql(ct.level))
        return dataclasses.replace(ct, elements=hybrid.mod_down_pair(
            ct.elements[0], ct.elements[1], tabs)).SetMetadataByKey(
                "ext_basis", False)

    def KeySwitchDownFirstElement(self, ct: Ciphertext) -> torch.Tensor:
        """ApproxModDown of element 0 alone (reference
        KeySwitchDownFirstElement): the [size_ql, N] tensor."""
        return hybrid.mod_down_first(
            ct.elements[0], self.hybrid_tables(self.size_ql(ct.level)))

    # ------------------------------------------------------------------
    # AdvancedSHE: many-operand trees and rotation ladders (advanced.py)
    # ------------------------------------------------------------------

    def EvalAddMany(self, cts) -> Ciphertext:
        return advanced.eval_add_many(self, cts)

    def EvalMultMany(self, cts) -> Ciphertext:
        return advanced.eval_mult_many(self, cts)

    def EvalSumKeyGen(self, sk: PrivateKey, batch_size=None) -> None:
        advanced.eval_sum_keygen(self, sk, batch_size)
        self.eval_sum_keys[sk.key_tag] = True

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

    def JitPipeline(self, fn):
        """`fn` itself, run eagerly. The JAX package compiles a pipeline
        into one XLA program with the key maps and the plaintext cache as
        arguments; here every op launches as it is called, so there is
        nothing to compile and `cc.JitPipeline(fn)(ct)` is `fn(ct)`."""
        return fn

    # ------------------------------------------------------------------
    # CKKS bootstrapping (reference cryptocontext.h:3513-3548;
    # `fhe/ckks_bootstrap.py`)
    # ------------------------------------------------------------------

    def GetBootstrapDepth(self, level_budget=(1, 1)) -> int:
        """(reference FHECKKSRNS::GetBootstrapDepth)"""
        return ckks_bootstrap.get_bootstrap_depth(
            level_budget, self.params.secret_key_dist, self.ring_dim)

    def EvalBootstrapSetup(self, level_budget=(1, 1), dim1=(0, 0),
                           slots: int = 0, correction_factor: int = 0):
        if correction_factor == 0:
            correction_factor = getattr(self, "_boot_correction_override", 0)
        self._boot_setup_args = (level_budget, dim1, correction_factor)
        ckks_bootstrap.eval_bootstrap_setup(self, level_budget, dim1, slots,
                                            correction_factor)

    def EvalBootstrapPrecompute(self, slots: int = 0):
        """The precompute for another slot count with the Setup's level
        budgets (reference EvalBootstrapPrecompute,
        cryptocontext.h:3526)."""
        args = getattr(self, "_boot_setup_args", None)
        if args is None:
            raise RuntimeError("call EvalBootstrapSetup first")
        level_budget, dim1, correction = args
        ckks_bootstrap.eval_bootstrap_setup(self, level_budget, dim1, slots,
                                            correction)

    def EvalBootstrapKeyGen(self, sk: PrivateKey, slots: int = 0):
        ckks_bootstrap.eval_bootstrap_keygen(self, sk, slots)

    def EvalBootstrap(self, ct: Ciphertext, num_iterations: int = 1,
                      precision: int = 0) -> Ciphertext:
        return ckks_bootstrap.eval_bootstrap(self, ct, num_iterations,
                                             precision)

    def EvalBootstrapStCFirst(self, ct: Ciphertext, num_iterations: int = 1,
                              precision: int = 0) -> Ciphertext:
        """SlotsToCoeffs first, the output in slot form (reference
        EvalBootstrapStCFirst, ckksrns-fhe.cpp:839)."""
        return ckks_bootstrap.eval_bootstrap_stc_first(
            self, ct, num_iterations, precision)

    # ------------------------------------------------------------------
    # vectorized functional bootstrapping (reference cryptocontext.h:3568
    # EvalFBT / EvalMVB over the RLWE schemelet; `fhe/fbt.py`)
    # ------------------------------------------------------------------

    def EvalFBTSetup(self, num_slots: int = 0, p_in: int = 8,
                     correction_factor: int = 0):
        fbt.eval_fbt_setup(self, num_slots, p_in, correction_factor)

    def EvalFBTKeyGen(self, sk: PrivateKey, slots: int = 0):
        fbt.eval_fbt_keygen(self, sk, slots)

    def EvalFBT(self, ct: Ciphertext, lut, p_in: int, decode: bool = True,
                p_out: int = 0) -> Ciphertext:
        return fbt.eval_fbt(self, ct, lut, p_in, decode, p_out)

    def EvalFBTNoDecoding(self, ct: Ciphertext, lut,
                          p_in: int) -> Ciphertext:
        """(reference cryptocontext.h:3576) The FBT left in slot form."""
        return fbt.eval_fbt(self, ct, lut, p_in, decode=False)

    def EvalMVBPrecompute(self, ct: Ciphertext, p_in: int):
        """(reference cryptocontext.h:3588) The exponential powers that
        every LUT of a multi-value bootstrap shares."""
        return fbt.eval_mvb_precompute(self, ct, p_in)

    def EvalMVB(self, powers, lut, p_in: int, decode: bool = True,
                p_out: int = 0) -> Ciphertext:
        """(reference cryptocontext.h:3596) One LUT on precomputed
        powers."""
        return fbt.eval_mvb(self, powers, lut, p_in, decode, p_out)

    def EvalMVBNoDecoding(self, powers, lut, p_in: int) -> Ciphertext:
        return fbt.eval_mvb(self, powers, lut, p_in, decode=False)

    def EvalHomDecoding(self, ct: Ciphertext, p_out: int,
                        slots: int | None = None) -> Ciphertext:
        """(reference cryptocontext.h:3585)"""
        return fbt.eval_hom_decoding(self, ct, p_out, slots)

    def EvalHermiteTrigSeries(self, ct_exp: Ciphertext, func, p: int,
                              order: int = 1,
                              scale: float = 1.0) -> Ciphertext:
        """A Hermite trigonometric interpolation of `func` on a ciphertext
        of exp(2 pi i x / p) (reference EvalHermiteTrigSeries,
        cryptocontext.h:3609; coefficients from `math/hermite.py`): the
        real part of the result is func(x)."""
        coeffs = get_hermite_trig_coefficients(func, p, order, scale)
        return advanced.eval_poly_linear(self, ct_exp,
                                         [complex(c) for c in coeffs])

    # ------------------------------------------------------------------
    # PRE (reference ReKeyGen / ReEncrypt, cryptocontext.h:3043)
    # ------------------------------------------------------------------

    def ReKeyGen(self, old_sk: PrivateKey, new_key) -> EvalKey:
        return pre.re_key_gen(self, old_sk, new_key)

    def ReEncrypt(self, ct: Ciphertext, re_key: EvalKey,
                  public_key: PublicKey | None = None) -> Ciphertext:
        return pre.re_encrypt(self, ct, re_key, public_key)

    # ------------------------------------------------------------------
    # multiparty (reference cryptocontext.h:3088-3151, 3337)
    # ------------------------------------------------------------------

    def MultipartyKeyGen(self, prev_pk: PublicKey | None = None) -> KeyPair:
        return mp.multiparty_key_gen(self, prev_pk)

    def MultipartyDecryptLead(self, cts, sk: PrivateKey):
        """One ciphertext or a list of them."""
        if isinstance(cts, (list, tuple)):
            return [mp.multiparty_decrypt_lead(self, c, sk) for c in cts]
        return mp.multiparty_decrypt_lead(self, cts, sk)

    def MultipartyDecryptMain(self, cts, sk: PrivateKey):
        if isinstance(cts, (list, tuple)):
            return [mp.multiparty_decrypt_main(self, c, sk) for c in cts]
        return mp.multiparty_decrypt_main(self, cts, sk)

    def MultipartyDecryptFusion(self, partials, ct_meta=None) -> Plaintext:
        return mp.multiparty_decrypt_fusion(self, partials,
                                            ct_meta or partials[0])

    def MultiAddPubKeys(self, pk1: PublicKey, pk2: PublicKey,
                        key_tag: str = "") -> PublicKey:
        return mp.multi_add_pub_keys(self, pk1, pk2, key_tag)

    def MultiKeySwitchGen(self, original_sk: PrivateKey, new_sk: PrivateKey,
                          ek_prev: EvalKey) -> EvalKey:
        return mp.multi_key_switch_gen(self, original_sk, new_sk, ek_prev)

    def MultiAddEvalKeys(self, ek1: EvalKey, ek2: EvalKey,
                         key_tag: str = "") -> EvalKey:
        return mp.multi_add_evalkeys(self, ek1, ek2, key_tag)

    def MultiMultEvalKey(self, ek: EvalKey, sk: PrivateKey,
                         key_tag: str = "") -> EvalKey:
        return mp.multi_mult_eval_key(self, ek, sk, key_tag)

    def MultiAddEvalMultKeys(self, ek1: EvalKey, ek2: EvalKey,
                             key_tag: str = "") -> EvalKey:
        return mp.multi_add_evalmult_keys(self, ek1, ek2, key_tag)

    def MultiEvalAutomorphismKeyGen(self, sk: PrivateKey, ek_prev_map: dict,
                                    g_list, key_tag: str = "") -> dict:
        return mp.multi_eval_automorphism_keygen(self, sk, ek_prev_map,
                                                 g_list, key_tag)

    def MultiAddAutomorphismKeys(self, m1: dict, m2: dict,
                                 key_tag: str = "") -> dict:
        return mp.multi_add_automorphism_keys(self, m1, m2, key_tag)

    def ShareKeys(self, sk: PrivateKey, num_parties: int, threshold: int,
                  seed: int = 0) -> dict:
        return mp.share_keys(self, sk, num_parties, threshold, seed)

    def RecoverSharedKey(self, shares: dict, key_tag: str = "") -> PrivateKey:
        return mp.recover_shared_key(self, shares, key_tag)

    # interactive (two-round) bootstrapping (reference cryptocontext.h
    # IntBoot* / IntMPBoot*)

    def IntBootAdjustScale(self, ct: Ciphertext) -> Ciphertext:
        return mp.int_boot_adjust_scale(self, ct)

    def IntBootDecrypt(self, sk: PrivateKey, ct: Ciphertext) -> Ciphertext:
        return mp.int_boot_decrypt(self, sk, ct)

    def IntBootEncrypt(self, pk: PublicKey, ct_share: Ciphertext
                       ) -> Ciphertext:
        return mp.int_boot_encrypt(self, pk, ct_share)

    def IntBootAdd(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        return mp.int_boot_add(self, ct1, ct2)

    def IntMPBootAdjustScale(self, ct: Ciphertext) -> Ciphertext:
        return mp.int_mp_boot_adjust_scale(self, ct)

    def IntMPBootRandomElementGen(self, pk: PublicKey) -> Ciphertext:
        return mp.int_mp_boot_random_element_gen(self, pk)

    def IntMPBootDecrypt(self, sk: PrivateKey, ct: Ciphertext,
                         a: Ciphertext) -> list:
        return mp.int_mp_boot_decrypt(self, sk, ct, a)

    def IntMPBootAdd(self, shares_vec: list) -> list:
        return mp.int_mp_boot_add(self, shares_vec)

    def IntMPBootEncrypt(self, pk: PublicKey, shares: list, a: Ciphertext,
                         ct: Ciphertext) -> Ciphertext:
        return mp.int_mp_boot_encrypt(self, pk, shares, a, ct)

    # ------------------------------------------------------------------
    # CKKS <-> FHEW scheme switching (reference cryptocontext.h:3653-3753;
    # `schemeswitch.py`)
    # ------------------------------------------------------------------

    def EvalCKKStoFHEWSetup(self, params: ssw.SchSwchParams | None = None):
        """The inner BinFHE context, on this context's device, and Q';
        returns the LWE secret key."""
        return ssw.eval_ckks_to_fhew_setup(self, params
                                           or ssw.SchSwchParams())

    def EvalCKKStoFHEWKeyGen(self, keys: KeyPair, lwe_sk) -> None:
        ssw.eval_ckks_to_fhew_keygen(self, keys, lwe_sk)

    def EvalCKKStoFHEWPrecompute(self, scale: float = 1.0) -> None:
        ssw.eval_ckks_to_fhew_precompute(self, scale)

    def EvalCKKStoFHEW(self, ct: Ciphertext, num_ctxts: int = 0):
        return ssw.eval_ckks_to_fhew(self, ct, num_ctxts)

    def EvalFHEWtoCKKSKeyGen(self, keys: KeyPair, lwe_sk) -> None:
        ssw.eval_fhew_to_ckks_keygen(self, keys, lwe_sk)

    def EvalFHEWtoCKKS(self, lwe_cts, num_ctxts: int = 0,
                       num_slots: int = 0, p: int = 4, pmin: float = 0.0,
                       pmax: float = 2.0) -> Ciphertext:
        return ssw.eval_fhew_to_ckks(self, lwe_cts, num_ctxts, num_slots,
                                     p, pmin, pmax)

    def EvalSchemeSwitchingSetup(self,
                                 params: ssw.SchSwchParams | None = None):
        return self.EvalCKKStoFHEWSetup(params)

    def EvalFHEWtoCKKSSetup(self, cc_lwe=None, num_slots: int = 0,
                            logq: int = 25) -> None:
        """(reference EvalFHEWtoCKKSSetup, cryptocontext.h:3734) One
        switching state serves both directions: made here when there is
        none, with `cc_lwe` wired in when given."""
        if self._schswch is None:
            self.EvalCKKStoFHEWSetup(None)
        if cc_lwe is not None:
            self._schswch.cc_lwe = cc_lwe

    def EvalSchemeSwitchingKeyGen(self, keys: KeyPair, lwe_sk) -> None:
        self.EvalCKKStoFHEWKeyGen(keys, lwe_sk)
        self.EvalFHEWtoCKKSKeyGen(keys, lwe_sk)

    def EvalCompareSwitchPrecompute(self, p_lwe: int = 0,
                                    scale_sign: float = 1.0) -> None:
        ssw.eval_compare_switch_precompute(self, p_lwe, scale_sign)

    def EvalCompareSchemeSwitching(self, ct1: Ciphertext, ct2: Ciphertext,
                                   num_ctxts: int = 0,
                                   num_slots: int = 0) -> Ciphertext:
        return ssw.eval_compare_scheme_switching(self, ct1, ct2, num_ctxts,
                                                 num_slots)

    def EvalMinSchemeSwitching(self, ct: Ciphertext, public_key,
                               num_values: int, num_slots: int = 0,
                               p_lwe: int = 0, scale_sign: float = 1.0):
        """(min, argmin one-hot indicator)"""
        return ssw.eval_min_scheme_switching(self, ct, public_key,
                                             num_values, num_slots, p_lwe,
                                             scale_sign)

    def EvalMaxSchemeSwitching(self, ct: Ciphertext, public_key,
                               num_values: int, num_slots: int = 0,
                               p_lwe: int = 0, scale_sign: float = 1.0):
        """(max, argmax one-hot indicator)"""
        return ssw.eval_max_scheme_switching(self, ct, public_key,
                                             num_values, num_slots, p_lwe,
                                             scale_sign)

    # the reference's *Alt variants (cryptocontext.h:3810-3850) trade a
    # level for fewer switches on long vectors; the tournament already
    # batches every comparison of a round, so both names share it
    EvalMinSchemeSwitchingAlt = EvalMinSchemeSwitching
    EvalMaxSchemeSwitchingAlt = EvalMaxSchemeSwitching

    def GetBinCCForSchemeSwitch(self):
        return self._schswch.cc_lwe

    def SetBinCCForSchemeSwitch(self, cc_lwe) -> None:
        """(reference cryptocontext.h:3944)"""
        self._schswch.cc_lwe = cc_lwe

    def GetSwkFC(self) -> Ciphertext:
        """The FHEW -> CKKS switching key: the CKKS encryption of the LWE
        secret (reference cryptocontext.h:3954)."""
        return self._schswch.fhew_to_ckks_swk

    def SetSwkFC(self, swk: Ciphertext) -> None:
        self._schswch.fhew_to_ckks_swk = swk


def GenCryptoContext(params: prm.CCParams, seed: int = 0,
                     device=None) -> CryptoContext:
    """(reference: gen-cryptocontext.h:88-92). `device` defaults to the
    GPU and raises when there is none."""
    return CryptoContext(params, seed=seed, device=device)
