"""BinFHEContext: the Boolean-FHE user API.

Counterpart of `openfhe_tpu/binfhe/context.py` for the narrow ring (Q <
2^31; reference analog: OpenFHE's src/binfhe/lib/binfhecontext.cpp and
binfhe-base-scheme.cpp: EvalBinGate :79, BootstrapGateCore :511,
EvalFunc :261, EvalFloor :335, EvalSign :380, EvalDecomp :452). Every op
takes batched ciphertexts: leading axes run through the whole pipeline,
blind rotation included, which is how the sequential n-step loop fills
the card. Parameter sets with more than 31 bits of Q (STD192 and the rest
of its class, custom contexts with q_bits > 31) run GINX on the
composite-Q ring of `rgsw_wide.py`: a 2-tower accumulator, the per-step
blind rotation on kernel m, and the sample extracted mod Q as int64 words
before the switch down to (n, q). AP and LMKCDEY refuse such sets, and so
does BTKeyGen's PUB_ENCRYPT, as in the JAX package.

    cc = BinFHEContext(seed=1).GenerateBinFHEContext("STD128")   # on cuda
    sk = cc.KeyGen(); cc.BTKeyGen(sk)
    out = cc.EvalBinGate(BINGATE.AND, cc.Encrypt(sk, a), cc.Encrypt(sk, b))
"""

from __future__ import annotations

import numpy as np
import torch

from openfhe_tpu_torch._device import resolve_device
from openfhe_tpu_torch.binfhe import blind_rotate, lwe, rgsw, rgsw_wide
from openfhe_tpu_torch.binfhe.constants import (BINFHE_METHOD, BINGATE,
                                                KEYGEN_MODE, PARAM_SETS,
                                                PRIME, gate_constants)
from openfhe_tpu_torch.math import nbtheory, sampling
from openfhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv


class BinFHEContext:
    """(reference BinFHEContext, binfhecontext.h) on one device: `cuda`
    unless another is named."""

    def __init__(self, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.method = BINFHE_METHOD.GINX
        self.bt_key = None
        self.ks_key = None
        self.sk_n = None
        self.pk = None
        self.wide = False
        self.rgsw_w = None

    # ------------------------------------------------------------------
    # context generation (binfhecontext.cpp:108)
    # ------------------------------------------------------------------

    def _set_ring(self, n: int, big_n: int, q: int, q_bits: int,
                  base_g: int, method) -> None:
        if isinstance(method, str):
            method = BINFHE_METHOD[method]
        self.method = method
        self.n, self.N, self.q = n, big_n, q
        self.wide = q_bits > 31
        if self.wide:
            # more than 31 bits of Q: the 2-tower composite ring
            if method != BINFHE_METHOD.GINX:
                raise ValueError(
                    f"a {q_bits}-bit accumulator modulus needs the "
                    "composite-Q ring, which only GINX supports (AP / "
                    "LMKCDEY: use a set with Q < 2^31, e.g. "
                    "STD256_LMKCDEY)")
            self.rgsw_w = rgsw_wide.make_rgsw_wide_params(
                n, big_n, q_bits, q, base_g, self.device)
            self.Q = self.rgsw_w.big_q
            self.rgsw = None
        else:
            # LastPrime(bits, 2N): largest `bits`-bit prime = 1 mod 2N
            self.Q = nbtheory.previous_prime(1 << q_bits, 2 * big_n)
            self.rgsw = rgsw.make_rgsw_params(n, big_n, self.Q, q, base_g,
                                              self.device)
            self.rgsw_w = None
        self.gate_const = gate_constants(q)

    def GenerateBinFHEContext(self, param_set: str = "STD128",
                              method: BINFHE_METHOD = BINFHE_METHOD.GINX,
                              seed: int | None = None):
        if param_set not in PARAM_SETS:
            raise ValueError(f"unknown parameter set {param_set!r}; "
                             f"choose one of {sorted(PARAM_SETS)}")
        p = PARAM_SETS[param_set]
        self._set_ring(p.lattice_param, p.cyc_order // 2, p.mod,
                       p.number_bits, p.base_g, method)
        self.std = p.std_dev
        self.base_ks = p.base_ks
        self.q_ks = self.Q if p.mod_ks == PRIME else p.mod_ks
        self.base_r = p.base_rk
        self.num_auto_keys = p.num_auto_keys
        return self

    def GenerateBinFHEContextCustom(self, n: int, N: int, q: int,
                                    q_bits: int, base_ks: int, base_g: int,
                                    std: float = 3.19,
                                    method: BINFHE_METHOD =
                                    BINFHE_METHOD.GINX,
                                    base_r: int = 23,
                                    num_auto_keys: int = 10):
        """Fully-custom context (reference GenerateBinFHEContext overload,
        binfhecontext.cpp:45). Use for experiments/tests; the named
        parameter sets carry the published security estimates."""
        self._set_ring(n, N, q, q_bits, base_g, method)
        self.std = std
        self.base_ks = base_ks
        # a wide Q does not fit the switching key's words: a power of two
        # of about half its bits (the JAX package's choice)
        self.q_ks = 1 << max(10, q_bits // 2 - 4) if self.wide else self.Q
        self.base_r = base_r
        self.num_auto_keys = num_auto_keys
        return self

    # ------------------------------------------------------------------
    # keys
    # ------------------------------------------------------------------

    def KeyGen(self) -> lwe.LWEPrivateKey:
        self.sk = lwe.key_gen(self.gen, self.n)
        return self.sk

    def KeyGenPair(self):
        """(binfhecontext.cpp:210) -> (pk, skN) at ring dimension N mod Q;
        BTKeyGen afterwards reuses this skN so pk-encrypted ciphertexts
        switch onto the bootstrap path."""
        self.sk_n = lwe.key_gen(self.gen, self.N)
        return lwe.pub_key_gen(self.gen, self.sk_n, self.Q), self.sk_n

    def PubKeyGen(self, sk_n: lwe.LWEPrivateKey) -> lwe.LWEPublicKey:
        """(binfhecontext.cpp:214)"""
        return lwe.pub_key_gen(self.gen, sk_n, self.Q)

    def GetPublicKey(self) -> lwe.LWEPublicKey:
        """(binfhecontext.h:171) the pk stored by BTKeyGen(PUB_ENCRYPT)."""
        if self.pk is None:
            raise ValueError("no public key: call BTKeyGen(sk, "
                             "keygen_mode=KEYGEN_MODE.PUB_ENCRYPT) first")
        return self.pk

    def BTKeyGen(self, sk: lwe.LWEPrivateKey,
                 keygen_mode=KEYGEN_MODE.SYM_ENCRYPT) -> None:
        """(binfhe-base-scheme.cpp BTKeyGen :40): KS key + blind-rotation
        key for the ring secret, per the configured method. With
        keygen_mode=PUB_ENCRYPT a public key for the ring secret is also
        generated and stored."""
        if self.sk_n is None:
            self.sk_n = lwe.key_gen(self.gen, self.N)
        sk_n = self.sk_n
        if self.wide:
            self._bt_keygen_wide(sk, sk_n, keygen_mode)
            return
        if keygen_mode == KEYGEN_MODE.PUB_ENCRYPT:
            self.pk = lwe.pub_key_gen(self.gen, sk_n, self.Q)
        params = self.rgsw
        sk_n_eval = rgsw._fwd1(torch.remainder(sk_n.s.long(), self.Q),
                               params.basis)
        self.ks_key = lwe.key_switch_gen(self.gen, sk, sk_n, self.q_ks,
                                         self.base_ks, self.std)
        if self.method == BINFHE_METHOD.GINX:
            self.bt_key = rgsw.keygen_cggi_pair(self.gen, params, sk_n_eval,
                                                sk.s, self.std)
        elif self.method == BINFHE_METHOD.AP:
            self.bt_key = rgsw.keygen_dm(self.gen, params, sk_n_eval, sk.s,
                                         self.base_r, self.std)
        else:   # LMKCDEY
            s_host = sk.s.cpu().numpy().astype(np.int64)
            rgsw_keys = rgsw.keygen_rgsw_monomial(
                self.gen, params, sk_n_eval, [int(v) for v in s_host],
                self.std)
            w = self.num_auto_keys
            m = 2 * self.N
            auto_keys = {j: rgsw.keygen_auto(
                self.gen, params, sk_n_eval,
                m - 5 if j == 0 else pow(5, j, m), self.std)
                for j in range(w + 1)}
            # unified key bank + permutation table: the blind rotation
            # runs one uniform step form over a host-built schedule
            # (rgsw.build_lmkcdey_schedule), batched across gates
            self.bt_key = (
                rgsw.lmkcdey_key_bank(params, rgsw_keys, auto_keys, w),
                torch.from_numpy(rgsw.lmkcdey_perm_table(params, w)).to(
                    self.device),
                w)

    def _bt_keygen_wide(self, sk, sk_n, keygen_mode) -> None:
        """BTKeyGen on the composite-Q ring: the switching key from the
        ring secret and the 2-tower GINX key."""
        if keygen_mode == KEYGEN_MODE.PUB_ENCRYPT:
            raise ValueError("public-key workflows are not supported on "
                             "composite-Q (wide) parameter sets")
        bw = self.rgsw_w.basis
        sk_n_eval = ntt_fwd(sampling.to_residues(sk_n.s, bw), bw)
        self.ks_key = lwe.key_switch_gen(self.gen, sk, sk_n, self.q_ks,
                                         self.base_ks, self.std)
        self.bt_key = rgsw_wide.keygen_cggi_pair_wide(
            self.gen, self.rgsw_w, sk_n_eval, sk.s, self.std)

    def _eval_acc(self, acc0, acc1, a, q_lwe: int | None = None):
        """Dispatch blind rotation on the configured method (the
        composite-Q ring's GINX on a wide set)."""
        if self.wide:
            return rgsw_wide.eval_acc_cggi_wide(
                self.rgsw_w.replace(q_lwe=q_lwe or self.q), self.bt_key,
                acc0, acc1, a)
        params = self.rgsw if q_lwe is None \
            else self.rgsw.replace(q_lwe=q_lwe)
        if self.method == BINFHE_METHOD.GINX:
            return rgsw.eval_acc_cggi(params, self.bt_key, acc0, acc1, a)
        if self.method == BINFHE_METHOD.AP:
            ek, digits_r = self.bt_key
            return rgsw.eval_acc_dm(params, ek, digits_r, self.base_r,
                                    acc0, acc1, a)
        # LMKCDEY: per-gate schedules (a pure function of the public a
        # vector) built on the host, padded with no-op steps to the
        # longest, and run as one batched blind rotation
        key_bank, perm_table, w = self.bt_key
        lead = a.shape[:-1]
        sched = blind_rotate.lmkcdey_sched(params, a.reshape(-1, a.shape[-1]),
                                           w)
        return rgsw.eval_acc_lmkcdey_scan(
            params, key_bank, perm_table,
            sched.reshape((sched.shape[0],) + lead + (5,)), acc0, acc1)

    # ------------------------------------------------------------------
    # encryption
    # ------------------------------------------------------------------

    def Encrypt(self, sk, m, p: int = 4, q: int | None = None,
                output: str = "SMALL_DIM") -> lwe.LWECiphertext:
        """Secret-key or public-key encryption (binfhecontext.cpp:220/:235).
        With a public key the ciphertext is produced at (N, Q) and, for
        SMALL_DIM output, switched down to (n, q) through the BTKeyGen
        switching key."""
        if isinstance(sk, lwe.LWEPublicKey):
            ct = lwe.encrypt_pub(self.gen, sk, m, self.Q, p, self.std)
            if output == "SMALL_DIM":
                if self.ks_key is None:
                    raise ValueError("public-key SMALL_DIM encryption needs "
                                     "BTKeyGen first (switching key)")
                ct = lwe.switch_ct_to_qn(self.ks_key, q or self.q, ct)
                ct = ct.replace(pt_modulus=p)
            return ct
        return lwe.encrypt(self.gen, sk, m, q or self.q, p, self.std)

    def Decrypt(self, sk: lwe.LWEPrivateKey, ct: lwe.LWECiphertext,
                p: int | None = None) -> np.ndarray:
        if p is not None and p != ct.pt_modulus:
            ct = ct.replace(pt_modulus=p)
        return lwe.decrypt(sk, ct)

    def EvalNOT(self, ct: lwe.LWECiphertext) -> lwe.LWECiphertext:
        return lwe.eval_not(ct)

    def EvalConstant(self, value) -> lwe.LWECiphertext:
        return lwe.noiseless_embedding(self.n, value, self.q,
                                       device=self.device)

    # ------------------------------------------------------------------
    # gate bootstrapping (binfhe-base-scheme.cpp:79-135, :511)
    # ------------------------------------------------------------------

    def _test_vector(self, b: torch.Tensor, gate: BINGATE,
                     p: int = 4) -> torch.Tensor:
        """Gate-dependent test polynomial in COEFF, batched over b [...]."""
        q, big_q, big_n = self.q, self.Q, self.N
        q_half = q >> 1
        q1 = self.gate_const[int(gate)]
        q2 = (q1 + q_half) % q
        lb, ub, swap = (q2, q1, True) if q1 >= q2 else (q1, q2, False)
        q2p = big_q // (p * 2) + 1
        lv, uv = (q2p, big_q - q2p) if swap else (big_q - q2p, q2p)
        factor = big_n // q_half
        # row i (i < q/2): value depends on (b - i) mod q in [lb, ub)
        i_idx = torch.arange(q_half, device=b.device)
        bi = torch.remainder(b.long()[..., None] - i_idx, q)
        return self._test_poly(torch.where((bi >= lb) & (bi < ub), lv, uv),
                               factor)

    def _test_poly(self, vals: torch.Tensor, factor: int) -> torch.Tensor:
        """A test vector's values [..., N / factor] (int64 mod Q) at every
        factor-th coefficient: [..., N] int32, or its residues [..., 2, N]
        on the composite-Q ring."""
        lead = tuple(vals.shape[:-1])
        if self.wide:
            vals = torch.remainder(vals[..., None, :], self.rgsw_w.q_col)
            lead += (2,)
        m = torch.zeros(lead + (self.N,), dtype=torch.int32,
                        device=vals.device)
        m[..., ::factor] = vals.int()
        return m

    def _acc_init(self, m: torch.Tensor) -> tuple:
        """(acc0, acc1) = (0, NTT(m)) for a test polynomial m."""
        acc1 = (ntt_fwd(m, self.rgsw_w.basis) if self.wide
                else rgsw._fwd1(m, self.rgsw.basis))
        return torch.zeros_like(acc1), acc1

    def _extract(self, acc0, acc1, extra_b: int, pt_modulus: int):
        """INTT the accumulator (one call over both halves) and read it as
        an LWE sample mod Q: a = Transpose(acc0), b = acc1[0] + extra_b. On
        the composite-Q ring the coefficients come back from their two
        residues by Garner, and the sample holds int64 words."""
        big_q, big_n = self.Q, self.N
        if self.wide:
            p = rgsw_wide.garner(self.rgsw_w, ntt_inv(
                torch.stack([acc0, acc1], dim=-3), self.rgsw_w.basis))
        else:
            p = rgsw._inv1(torch.stack([acc0, acc1], dim=-2),
                           self.rgsw.basis)
        # Transpose: a(X) -> a(X^-1): a'_0 = a_0, a'_k = -a_{N-k}
        rev = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.arange(big_n - 1, 0, -1)]).to(self.device)
        a_t = p[..., 0, :][..., rev].long()
        a_t[..., 1:] = torch.remainder(-a_t[..., 1:], big_q)
        b = torch.remainder(p[..., 1, 0].long() + extra_b, big_q)
        dtype = lwe.word_dtype(big_q)
        return lwe.LWECiphertext(a=a_t.to(dtype), b=b.to(dtype),
                                 modulus=big_q, pt_modulus=pt_modulus)

    def _bootstrap_core(self, ct, gate: BINGATE, p: int, extra_b: int):
        """Init the accumulator with the test vector, run blind rotation,
        extract the constant coefficient as an LWE sample mod Q. The
        composite-Q ring rotates by the ciphertext's own modulus, as the
        JAX package's wide path does."""
        if self.bt_key is None:
            raise ValueError("bootstrapping keys have not been generated; "
                             "call BTKeyGen before gate evaluation")
        acc0, acc1 = self._acc_init(self._test_vector(ct.b, gate, p))
        acc0, acc1 = self._eval_acc(acc0, acc1, ct.a, q_lwe=(
            int(ct.modulus) if self.wide else None))
        return self._extract(acc0, acc1, extra_b, p)

    def _to_small(self, ct: lwe.LWECiphertext) -> lwe.LWECiphertext:
        """A ciphertext at (N, Q) switched to (n, q); others unchanged."""
        if ct.modulus == self.Q:
            return lwe.switch_ct_to_qn(self.ks_key, self.q, ct)
        return ct

    def EvalBinGate(self, gate: BINGATE, ct1, ct2=None) -> lwe.LWECiphertext:
        """(binfhe-base-scheme.cpp EvalBinGate :79 two-input, :135
        multi-input). ct1 may be a list of >= 3 ciphertexts."""
        if ct2 is None and isinstance(ct1, (list, tuple)):
            return self._eval_multi_gate(gate, list(ct1))
        cct = lwe.eval_add(self._to_small(ct1), self._to_small(ct2))
        if gate in (BINGATE.XOR, BINGATE.XNOR, BINGATE.XOR_FAST,
                    BINGATE.XNOR_FAST):
            cct = lwe.eval_add(cct, cct)
        # map back to mod-2 arithmetic: b += Q/8 + 1 (p = 4)
        ct_ext = self._bootstrap_core(cct, gate, 4, (self.Q >> 3) + 1)
        return lwe.switch_ct_to_qn(self.ks_key, self.q, ct_ext)

    def _eval_multi_gate(self, gate: BINGATE, cts) -> lwe.LWECiphertext:
        """3/4-input gates and MAJORITY (binfhe-base-scheme.cpp :147);
        CMUX composed from NANDs (:178)."""
        if gate == BINGATE.CMUX:
            if len(cts) != 3:
                raise ValueError("CMUX takes exactly 3 ciphertexts")
            return self.EvalCMUX(cts[0], cts[1], cts[2])
        cts = [self._to_small(c) for c in cts]
        acc = cts[0]
        for c in cts[1:]:
            acc = lwe.eval_add(acc, c)
        p = cts[0].pt_modulus
        ct_ext = self._bootstrap_core(acc, gate, p, self.Q // (2 * p) + 1)
        return lwe.switch_ct_to_qn(self.ks_key, self.q,
                                   ct_ext).replace(pt_modulus=p)

    def EvalCMUX(self, ct0, ct1, sel) -> lwe.LWECiphertext:
        """sel ? ct1 : ct0 via three NANDs (binfhe-base-scheme.cpp :181)."""
        n1 = self.EvalBinGate(BINGATE.NAND, ct0, self.EvalNOT(sel))
        n2 = self.EvalBinGate(BINGATE.NAND, ct1, sel)
        return self.EvalBinGate(BINGATE.NAND, n1, n2)

    def Bootstrap(self, ct) -> lwe.LWECiphertext:
        """Noise refresh of a single ciphertext (binfhe-base-scheme.cpp
        Bootstrap :318): add q/4, run the AND test polynomial, re-center."""
        ct = self._to_small(ct)
        p = ct.pt_modulus
        cct = lwe.add_const(ct, ct.modulus >> 2)
        ct_ext = self._bootstrap_core(cct, BINGATE.AND, p,
                                      self.Q // (2 * p) + 1)
        return lwe.switch_ct_to_qn(self.ks_key, self.q,
                                   ct_ext).replace(pt_modulus=p)

    # ------------------------------------------------------------------
    # functional bootstrapping (binfhe-base-scheme.cpp BootstrapFunc*,
    # EvalFunc :261-345)
    # ------------------------------------------------------------------

    @property
    def beta(self) -> int:
        """Noise margin added before functional bootstraps
        (binfhecontext.h GetBeta = 128)."""
        return 128

    def GetMaxPlaintextSpace(self) -> int:
        return self.q // (self.beta << 1)

    def GenerateLUTviaFunction(self, f, p: int) -> np.ndarray:
        """(binfhecontext.cpp GenerateLUTviaFunction): LUT over Z_q with
        entries (q/p) * f(x/(q/p), p)."""
        q = self.q
        lut = np.zeros(q, np.int64)
        for i in range(q):
            v = int(f((i * p) // q, p))
            if v >= p:
                raise ValueError("function must output in Z_p")
            lut[i] = (q // p) * v
        return lut

    def _bootstrap_func(self, ct, fv_q: np.ndarray, fmod: int,
                        out_mod: int | None = None) -> lwe.LWECiphertext:
        """BootstrapFunc: blind-rotate with test vector Q/fmod * f(b - j),
        then ModSwitch -> KeySwitch -> ModSwitch(fmod).

        fv_q: host LUT over Z_{ct.modulus} with values already in Z_fmod.
        """
        if self.bt_key is None:
            raise ValueError("bootstrapping keys have not been generated; "
                             "call BTKeyGen before functional bootstraps")
        q_ct, big_q, big_n = ct.modulus, self.Q, self.N
        factor = (2 * big_n) // q_ct
        fv = torch.from_numpy((fv_q.astype(np.int64) % fmod)
                              * (big_q // fmod) % big_q).to(self.device)
        bi = torch.remainder(ct.b.long()[..., None]
                             - torch.arange(q_ct >> 1, device=self.device),
                             q_ct)
        acc0, acc1 = self._acc_init(self._test_poly(fv[bi], factor))
        # blind rotation indices use the ciphertext modulus of `ct`
        acc0, acc1 = self._eval_acc(acc0, acc1, ct.a, q_lwe=q_ct)
        ct_ext = self._extract(acc0, acc1, 0, ct.pt_modulus)
        return lwe.switch_ct_to_qn(self.ks_key, out_mod or fmod, ct_ext)

    @staticmethod
    def _check_input_function(lut: np.ndarray, q: int) -> int:
        """0 = negacyclic, 1 = periodic, 2 = arbitrary
        (binfhe-base-scheme.h checkInputFunction)."""
        half = q // 2
        if np.all((lut[:half] + lut[half:]) % q == 0):
            return 0
        if np.all(lut[:half] == lut[half:]):
            return 1
        return 2

    def EvalFunc(self, ct, lut) -> lwe.LWECiphertext:
        """Arbitrary-function evaluation via functional bootstrapping
        (binfhe-base-scheme.cpp EvalFunc :261). The working modulus is the
        ciphertext's (EvalFunc :253), not the context default."""
        q = int(ct.modulus)
        lut = np.asarray(lut, np.int64)
        if lut.shape[0] != q:
            raise ValueError(f"LUT length {lut.shape[0]} != ciphertext "
                             f"modulus {q}; generate the LUT for the "
                             "modulus the ciphertext lives at")
        prop = self._check_input_function(lut, q)
        beta = self.beta
        p = ct.pt_modulus

        if prop == 0:       # negacyclic: a single bootstrap
            return self._bootstrap_func(lwe.add_const(ct, beta), lut,
                                        q).replace(pt_modulus=p)

        if prop == 2:       # arbitrary: raise modulus q -> 2q
            if q > self.N:
                raise ValueError("q must be <= N for arbitrary functions")
            dq = 2 * q
            ct1 = ct.replace(modulus=dq)          # ct viewed mod 2q
            # f0: map to +-q/4 depending on the half of Z_2q
            x = np.arange(dq, dtype=np.int64)
            f0 = np.where(x < q, dq - (q >> 1), (q >> 1)).astype(np.int64)
            ct3 = self._bootstrap_func(lwe.add_const(ct1, beta), f0, dq)
            ct1 = lwe.eval_sub(ct1, ct3)
            ct3b = lwe.add_const(ct1, beta - (q >> 1))
            # now the input lies in [0, q); evaluate the doubled LUT
            lut2 = np.concatenate([lut, lut])
            fl = np.where(x < q, lut2[x], (dq - lut2[x - q]) % dq)
            ct4 = self._bootstrap_func(ct3b, fl, dq)
            return lwe.reduce_mod(ct4, q).replace(pt_modulus=p)

        # periodic: compose two bootstraps (reference :330-345)
        x = np.arange(q, dtype=np.int64)
        f0 = np.where(x < (q >> 1), q - (q >> 2), (q >> 2)).astype(np.int64)
        ct2 = self._bootstrap_func(lwe.add_const(ct, beta), f0, q)
        ct2 = lwe.eval_sub(ct, ct2)      # original ct, without the beta shift
        ct2 = lwe.add_const(ct2, beta - (q >> 2))
        fl = np.where(x < (q >> 1), lut[x], (q - lut[(x - (q >> 1)) % q]) % q)
        return self._bootstrap_func(ct2, fl, q).replace(pt_modulus=p)

    # ------------------------------------------------------------------
    # large-precision ops (binfhe-base-scheme.cpp :334-490,
    # eprint 2021/1337)
    # ------------------------------------------------------------------

    def EvalFloor(self, ct, round_bits: int = 0) -> lwe.LWECiphertext:
        """Clear the low log2(q) bits of a large-modulus ciphertext
        (binfhe-base-scheme.cpp EvalFloor :335)."""
        beta = self.beta
        q = self.q if round_bits == 0 else beta * (1 << (round_bits + 1))
        mod = ct.modulus
        ct1 = lwe.add_const(ct, beta)
        x = np.arange(q, dtype=np.int64)
        # f1: +-q/4 by the half of Z_q (values live in Z_mod)
        f1 = np.where(x < (q >> 1), mod - (q >> 2), (q >> 2)).astype(np.int64)
        ct2 = self._bootstrap_func(lwe.reduce_mod(ct1, q), f1, mod)
        ct1 = lwe.eval_sub(ct1, ct2)
        # f2: identity-ish on [q/4, 3q/4), reflected outside
        f2 = np.where(
            x < (q >> 2), (mod - (q >> 1) - x) % mod,
            np.where(x < 3 * (q >> 2), x, (mod + (q >> 1) - x) % mod)
        ).astype(np.int64)
        ct3 = self._bootstrap_func(lwe.reduce_mod(ct1, q), f2, mod)
        return lwe.eval_sub(ct1, ct3)

    def EvalSign(self, ct, scheme_switch: bool = False) -> lwe.LWECiphertext:
        """Large-precision sign via iterated flooring
        (binfhe-base-scheme.cpp EvalSign :380). With scheme_switch=True,
        uses the negated final map and skips the q/4 recentering (the
        encoding EvalFHEWtoCKKS expects, reference :440-447)."""
        beta = self.beta
        q = self.q
        mod = ct.modulus
        if mod <= q:
            raise ValueError("EvalSign is for large-precision inputs; use "
                             "Bootstrap for small precision")
        cttmp = ct
        while mod > q:
            cttmp = self.EvalFloor(cttmp)
            mod = (mod * 2 * beta) // q
            cttmp = lwe.mod_switch(mod, cttmp)
        cttmp = lwe.add_const(cttmp, beta)
        x = np.arange(mod, dtype=np.int64)
        if scheme_switch:
            f3 = np.where(x < mod // 2, (q - q // 4) % q,
                          q // 4).astype(np.int64)
            return self._bootstrap_func(cttmp, f3, q).replace(pt_modulus=4)
        f3 = np.where(x < mod // 2, q // 4, (q - q // 4) % q).astype(np.int64)
        out = self._bootstrap_func(cttmp, f3, q)
        return lwe.add_const(out, -(q >> 2)).replace(pt_modulus=2)

    def EvalDecomp(self, ct) -> list:
        """Decompose a large-precision ciphertext into digits mod q
        (binfhe-base-scheme.cpp EvalDecomp :452)."""
        beta = self.beta
        q = self.q
        mod = ct.modulus
        cttmp = ct
        out = []
        while mod > q:
            out.append(lwe.reduce_mod(cttmp, q))
            cttmp = self.EvalFloor(cttmp)
            mod = (mod * 2 * beta) // q
            cttmp = lwe.mod_switch(mod, cttmp)
        out.append(cttmp)
        return out
