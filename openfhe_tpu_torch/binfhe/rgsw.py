"""RGSW parameters, gadget decomposition and the blind rotations.

Counterpart of `openfhe_tpu/binfhe/rgsw.py` (the narrow ring: Q < 2^31;
reference analog: OpenFHE's src/binfhe/lib/rgsw-cryptoparameters.cpp,
rgsw-acc.cpp SignedDigitDecompose, rgsw-acc-cggi.cpp, rgsw-acc-dm.cpp and
rgsw-acc-lmkcdey.cpp).

* The GINX bootstrapping key is one tensor [n, 2, digitsG2, 2, N] (per
  LWE coordinate, two ternary-CMUX keys, gadget rows, (a, b), EVAL).
* A blind rotation (the JAX package's `lax.scan`) is one launch of
  `csrc/blind_rotate.cu` on the card (`blind_rotate.py`): every gate's
  whole step loop in one thread block. On the CPU it is the per-step
  loop, batched over the gates: two NTT calls a step (one inverse over
  both accumulator halves stacked, one forward over the [..., d2, N]
  digits) and plain int64 torch for the key products and the monomial
  X^idx - 1 (slot j of X^t is psi^(t * e_j), e_j = 2 * brv(j) + 1). The
  same loop on the card, with kernel m (`ops/ntt_small.py`) for the NTTs,
  stays as `_eval_acc_*_steps`, the unfused chain the kernel is held
  against.
* Every modular sum is exact, so the words equal the JAX package's
  add_mod trees.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from openfhe_tpu_torch.binfhe import blind_rotate
from openfhe_tpu_torch.lattice.automorph import eval_indices
from openfhe_tpu_torch.lattice.basis import Basis, _bitrev_indices, make_basis
from openfhe_tpu_torch.math import sampling
from openfhe_tpu_torch.math.modops import to_u32
from openfhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv


@dataclasses.dataclass(frozen=True)
class RGSWParams:
    """RingGSW parameters + device tables for one (N, Q, baseG)."""
    basis: Basis                      # single-tower basis for Q at ring dim N
    psi_pow: torch.Tensor             # [2N] int64 powers of psi (monomials)
    eval_exp: torch.Tensor            # [N] int64 exponent e_j of slot j
    n_lwe: int = 0
    q_lwe: int = 0
    big_q: int = 0
    base_g: int = 0
    digits_g: int = 0

    @property
    def ring_dim(self) -> int:
        return self.basis.ring_dim

    @property
    def digits_g2(self) -> int:
        # approximate gadget decomposition drops the first digit
        return 2 * (self.digits_g - 1)

    @property
    def device(self) -> torch.device:
        return self.basis.device

    def replace(self, **changes) -> "RGSWParams":
        return dataclasses.replace(self, **changes)


def make_rgsw_params(n_lwe: int, ring_dim: int, big_q: int, q_lwe: int,
                     base_g: int, device="cpu") -> RGSWParams:
    basis = make_basis([big_q], ring_dim, device=device)
    digits_g = int(math.ceil(math.log(big_q) / math.log(base_g)))
    # psi_br[0, j] = psi^brv(j); brv-index 1 holds psi^1
    rev = _bitrev_indices(ring_dim)
    psi = int(to_u32(basis.psi_br)[0, rev[1]]) if ring_dim > 1 else 1
    pows = np.ones(2 * ring_dim, np.int64)
    for i in range(1, 2 * ring_dim):
        pows[i] = pows[i - 1] * psi % big_q
    eval_exp = (2 * rev.astype(np.int64) + 1) % (2 * ring_dim)
    return RGSWParams(basis=basis,
                      psi_pow=torch.from_numpy(pows).to(device),
                      eval_exp=torch.from_numpy(eval_exp).to(device),
                      n_lwe=n_lwe, q_lwe=q_lwe, big_q=big_q,
                      base_g=base_g, digits_g=digits_g)


def _fwd1(x: torch.Tensor, b: Basis) -> torch.Tensor:
    """Forward NTT of single-tower polynomials [..., N] (int32)."""
    return ntt_fwd(x.int().unsqueeze(-2).contiguous(), b).squeeze(-2)


def _inv1(x: torch.Tensor, b: Basis) -> torch.Tensor:
    """Inverse NTT of single-tower polynomials [..., N] (int32)."""
    return ntt_inv(x.int().unsqueeze(-2).contiguous(), b).squeeze(-2)


def monomial_eval(params: RGSWParams, t) -> torch.Tensor:
    """EVAL-domain values of X^t: slot j holds psi^(t * e_j).

    t: an int or a tensor [...]; returns int64 [..., N]."""
    two_n = 2 * params.ring_dim
    t = torch.as_tensor(t, dtype=torch.int64, device=params.device)
    return params.psi_pow[(t[..., None] * params.eval_exp) % two_n]


def _centered(params: RGSWParams, c: torch.Tensor) -> torch.Tensor:
    q = params.big_q
    c = c.long()
    return torch.where(c >= (q >> 1), c - q, c)


def _digit(d: torch.Tensor, g_bits: int):
    """Balanced low base-2^g digit of d and the rest: the low g bits of
    d's two's complement read as a signed g-bit number (the JAX package
    gets it from int32 shifts, `(d << (32-g)) >> (32-g)`, whose sign
    extension at bit 31 int64 would not give)."""
    half = 1 << (g_bits - 1)
    r = ((d & ((1 << g_bits) - 1)) ^ half) - half
    return r, (d - r) >> g_bits


def _digit_rows(params: RGSWParams, d: torch.Tensor) -> torch.Tensor:
    """digitsG - 1 balanced digits of centered d [..., m, N] after the
    dropped first one, as residues: [..., digitsG - 1, m, N] int32."""
    q = params.big_q
    g_bits = int(math.log2(params.base_g))
    _, d = _digit(d, g_bits)
    rows = []
    for _ in range(params.digits_g - 1):
        r, d = _digit(d, g_bits)
        rows.append(torch.where(r < 0, r + q, r))
    return torch.stack(rows, dim=-3).int()


def decompose_pair(params: RGSWParams, p: torch.Tensor) -> torch.Tensor:
    """signed_digit_decompose of the pair p [..., 2, N] (c0, c1 stacked):
    [..., digitsG2, N], even rows from c0, odd from c1."""
    rows = _digit_rows(params, _centered(params, p))      # [..., dg-1, 2, N]
    return rows.reshape(p.shape[:-2] + (params.digits_g2, p.shape[-1]))


def signed_digit_decompose(params: RGSWParams, c0: torch.Tensor,
                           c1: torch.Tensor) -> torch.Tensor:
    """Balanced base-2^g digits of (c0, c1), first digit dropped
    (rgsw-acc.cpp SignedDigitDecompose). Input [..., N] mod Q; output
    [..., digitsG2, N] int32 (even rows from c0, odd from c1)."""
    return decompose_pair(params, torch.stack([c0, c1], dim=-2))


def signed_digit_decompose_one(params: RGSWParams,
                               c: torch.Tensor) -> torch.Tensor:
    """Single-poly variant (digitsG-1 rows; rgsw-acc.cpp second overload)."""
    return _digit_rows(params, _centered(params, c)[..., None, :])[..., 0, :]


def _key_sum(params: RGSWParams, dct: torch.Tensor,
             key: torch.Tensor) -> torch.Tensor:
    """sum_r dct[..., r, :] * key[..., r, c, :] mod Q for c = 0, 1:
    dct [..., d2, N], key [..., d2, 2, N] -> [..., 2, N] int64."""
    q = params.big_q
    prod = torch.remainder(dct.long().unsqueeze(-2) * key.long(), q)
    return torch.remainder(prod.sum(-3), q)


def _gadget_rows(params: RGSWParams) -> torch.Tensor:
    """B^(r//2 + 1) mod Q for each of the d2 gadget rows, int64 [d2]."""
    q = params.big_q
    return torch.tensor([pow(params.base_g, (r // 2) + 1, q)
                         for r in range(params.digits_g2)],
                        dtype=torch.int64, device=params.device)


def _even_rows(params: RGSWParams) -> torch.Tensor:
    return torch.arange(params.digits_g2, device=params.device) % 2 == 0


def _rgsw_samples(gen: torch.Generator, params: RGSWParams,
                  sk_n_eval: torch.Tensor, lead: tuple, std: float):
    """(a_eval, b_eval = e_eval + a_eval * s) int64, [*lead, N] each."""
    b, q = params.basis, params.big_q
    a = sampling.uniform_residues(gen, b, lead_shape=lead)[..., 0, :]
    e = torch.remainder(sampling.discrete_gaussian(
        gen, lead + (params.ring_dim,), std).long(), q)
    a_eval = _fwd1(a, b).long()
    e_eval = _fwd1(e, b).long()
    return a_eval, torch.remainder(e_eval + a_eval * sk_n_eval.long(), q)


def keygen_cggi_pair(gen: torch.Generator, params: RGSWParams,
                     sk_n_eval: torch.Tensor, s_lwe: torch.Tensor,
                     std: float = 3.19) -> torch.Tensor:
    """CGGI bootstrapping key for all n LWE coordinates at once
    (rgsw-acc-cggi.cpp KeyGenAcc :40 + KeyGenCGGI :74).

    Returns [n, 2, digitsG2, 2, N] int32 EVAL: for coordinate i, key 0
    encrypts [s_i == 1], key 1 encrypts [s_i == -1].
    """
    q, d2 = params.big_q, params.digits_g2
    a_eval, b_eval = _rgsw_samples(gen, params, sk_n_eval,
                                   (params.n_lwe, 2, d2), std)
    s = s_lwe.long()
    mbits = torch.stack([s == 1, s == -1], dim=1)           # [n, 2]
    add = torch.where(mbits[:, :, None], _gadget_rows(params)[None, None],
                      0)[..., None]                          # [n, 2, d2, 1]
    even = _even_rows(params)[:, None]
    a_out = torch.remainder(a_eval + torch.where(even, add, 0), q)
    b_out = torch.remainder(b_eval + torch.where(even, 0, add), q)
    return torch.stack([a_out, b_out], dim=-2).int()        # [n,2,d2,2,N]


def _step_digits(params: RGSWParams, pair: torch.Tensor) -> torch.Tensor:
    """NTT(digits of INTT(pair)) for an accumulator pair [..., 2, N]: the
    two NTT calls of a step, [..., d2, N] int32."""
    b = params.basis
    return _fwd1(decompose_pair(params, _inv1(pair, b)), b)


def _cggi_step(params: RGSWParams, key: torch.Tensor, ix: torch.Tensor,
               acc: torch.Tensor) -> torch.Tensor:
    """One GINX step (AddToAccCGGI) on the pair acc [..., 2, N] int64: key
    [2, d2, 2, N] of the coordinate, ix [...] int64 its monomial
    exponent."""
    q = params.big_q
    two_n = 2 * params.ring_dim
    dct = _step_digits(params, acc)
    # monomials X^ix - 1 and X^-ix - 1 of the two CMUX keys
    mono = monomial_eval(params, torch.stack(
        [ix, torch.remainder(two_n - ix, two_n)], dim=-1))  # [..., 2, N]
    t = _key_sum(params, dct.unsqueeze(-3), key)              # [..., 2, 2, N]
    return torch.remainder(acc + torch.remainder(
        t * (mono - 1).unsqueeze(-2), q).sum(-3), q)


def _batch_pair(acc0, acc1, lead: tuple):
    """The accumulators broadcast to lead + [N] and flattened to [B, N]."""
    n = acc0.shape[-1]
    return tuple(a.expand(lead + (n,)).reshape(-1, n).contiguous()
                 for a in (acc0, acc1))


def _unbatch(pair, lead: tuple):
    return tuple(a.reshape(lead + a.shape[-1:]) for a in pair)


def _cggi(rotate, params: RGSWParams, bskey, acc0, acc1, a_lwe):
    lead = torch.broadcast_shapes(acc0.shape[:-1], acc1.shape[:-1],
                                  a_lwe.shape[:-1])
    a = a_lwe.expand(lead + a_lwe.shape[-1:]).reshape(-1, a_lwe.shape[-1])
    idx = blind_rotate.cggi_idx(params, a)
    return _unbatch(rotate(params, bskey, idx,
                           *_batch_pair(acc0, acc1, lead)), lead)


def eval_acc_cggi(params: RGSWParams, bskey: torch.Tensor, acc0, acc1,
                  a_lwe: torch.Tensor):
    """GINX blind rotation (rgsw-acc-cggi.cpp EvalAcc :61 + AddToAccCGGI).

    acc0/acc1: [..., N] EVAL mod Q. a_lwe: [..., n] mod q. The n steps of
    every gate run as one `blind_rotate_cggi` launch on the card, the
    per-step loop on the CPU (`blind_rotate.py`).
    """
    return _cggi(blind_rotate.blind_rotate_cggi, params, bskey, acc0, acc1,
                 a_lwe)


def _eval_acc_cggi_steps(params: RGSWParams, bskey: torch.Tensor, acc0,
                         acc1, a_lwe: torch.Tensor):
    """eval_acc_cggi as the per-step loop on any device (the unfused chain:
    on the card two kernel-m calls a step and plain torch around them)."""
    return _cggi(blind_rotate._cggi_ref, params, bskey, acc0, acc1, a_lwe)


def keygen_rgsw_monomial(gen: torch.Generator, params: RGSWParams,
                         sk_n_eval: torch.Tensor, ms,
                         std: float = 3.19) -> torch.Tensor:
    """RGSW encryptions of X^(m * 2N/q) for a list of integer messages
    (rgsw-acc-dm.cpp KeyGenDM :81 / rgsw-acc-lmkcdey.cpp KeyGenLMKCDEY).

    ms: host ints (may be negative). Returns [len(ms), d2, 2, N] EVAL.
    """
    big_n, q_lwe, q = params.ring_dim, params.q_lwe, params.big_q
    a_eval, b_eval = _rgsw_samples(gen, params, sk_n_eval,
                                   (len(ms), params.digits_g2), std)
    # message monomials +-X^mm in EVAL, per key
    factor = (2 * big_n) // q_lwe
    exps, signs = [], []
    for m in ms:
        mm = ((int(m) % q_lwe) + q_lwe) % q_lwe * factor
        sign = 1
        if mm >= big_n:
            mm -= big_n
            sign = -1
        exps.append(mm)
        signs.append(sign)
    mono = monomial_eval(params, torch.tensor(exps))        # [cnt, N]
    add = torch.remainder(mono[:, None, :]
                          * _gadget_rows(params)[None, :, None], q)
    sgn = torch.tensor(signs, device=params.device)[:, None, None]
    add = torch.where(sgn > 0, add, torch.remainder(-add, q))
    even = _even_rows(params)[None, :, None]
    a_out = torch.remainder(a_eval + torch.where(even, add, 0), q)
    b_out = torch.remainder(b_eval + torch.where(even, 0, add), q)
    return torch.stack([a_out, b_out], dim=-2).int()        # [cnt,d2,2,N]


def external_product_replace(params: RGSWParams, key_rows: torch.Tensor,
                             acc0, acc1):
    """acc <- ExternalProduct(acc, RGSW) (rgsw-acc-dm.cpp AddToAccDM)."""
    s = _key_sum(params, _step_digits(
        params, torch.stack([acc0, acc1], dim=-2)), key_rows)
    return s[..., 0, :].int(), s[..., 1, :].int()


# ---------------------------------------------------------------------------
# DM / AP accumulator (rgsw-acc-dm.cpp)
# ---------------------------------------------------------------------------

# keygen temporaries are a few times the key slice: bound each slice
KEYGEN_CHUNK_BYTES = 256 << 20


def keygen_dm(gen: torch.Generator, params: RGSWParams,
              sk_n_eval: torch.Tensor, s_lwe, base_r: int,
              std: float = 3.19):
    """AP bootstrapping key [n, digitsR, baseR, d2, 2, N]: RGSW(X^(s_i j
    R^k)) for every digit value j (including j=0, the identity monomial,
    so the accumulation loop is branch-free). Generated in slices of
    KEYGEN_CHUNK_BYTES into one preallocated tensor."""
    q_lwe = params.q_lwe
    digits_r = int(math.ceil(math.log(q_lwe) / math.log(base_r)))
    n = params.n_lwe
    s_host = np.asarray(torch.as_tensor(s_lwe).cpu(), np.int64)
    per_row = params.digits_g2 * 2 * params.ring_dim * 4
    if n * digits_r * base_r * per_row > (12 << 30):
        raise ValueError("AP key exceeds device memory for this parameter "
                         "set; use GINX")
    ms = [int(s_host[i]) * j * (base_r ** k)
          for i in range(n) for k in range(digits_r) for j in range(base_r)]
    ek = torch.empty((len(ms), params.digits_g2, 2, params.ring_dim),
                     dtype=torch.int32, device=params.device)
    chunk = max(1, KEYGEN_CHUNK_BYTES // per_row)
    for lo in range(0, len(ms), chunk):
        ek[lo:lo + chunk] = keygen_rgsw_monomial(gen, params, sk_n_eval,
                                                 ms[lo:lo + chunk], std)
    return ek.reshape(n, digits_r, base_r, params.digits_g2, 2,
                      params.ring_dim), digits_r


def _dm(rotate, params: RGSWParams, bskey, digits_r: int, base_r: int,
        acc0, acc1, a_lwe):
    lead = torch.broadcast_shapes(acc0.shape[:-1], acc1.shape[:-1],
                                  a_lwe.shape[:-1])
    a = a_lwe.expand(lead + a_lwe.shape[-1:]).reshape(-1, a_lwe.shape[-1])
    row = blind_rotate.dm_rows(params, digits_r, base_r, a)
    keys = bskey.reshape((-1,) + bskey.shape[-3:])
    return _unbatch(rotate(params, keys, row,
                           *_batch_pair(acc0, acc1, lead)), lead)


def eval_acc_dm(params: RGSWParams, bskey, digits_r: int, base_r: int,
                acc0, acc1, a_lwe: torch.Tensor):
    """AP blind rotation: n * digitsR steps with gathered keys, one
    `blind_rotate_dm` launch on the card."""
    return _dm(blind_rotate.blind_rotate_dm, params, bskey, digits_r, base_r,
               acc0, acc1, a_lwe)


def _eval_acc_dm_steps(params: RGSWParams, bskey, digits_r: int,
                       base_r: int, acc0, acc1, a_lwe: torch.Tensor):
    """eval_acc_dm as the per-step loop on any device (the unfused chain)."""
    return _dm(blind_rotate._dm_ref, params, bskey, digits_r, base_r, acc0,
               acc1, a_lwe)


# ---------------------------------------------------------------------------
# LMKCDEY accumulator (rgsw-acc-lmkcdey.cpp): host-scheduled automorphisms
# ---------------------------------------------------------------------------

def keygen_auto(gen: torch.Generator, params: RGSWParams,
                sk_n_eval: torch.Tensor, g: int, std: float = 3.19):
    """Automorphism switching key s(X^g) -> s, digitsG-1 rows
    (KeyGenAuto :201): [dg, 2, N] int32."""
    big_n, q = params.ring_dim, params.big_q
    dg = params.digits_g - 1
    idx = torch.from_numpy(eval_indices(big_n, g % (2 * big_n)).astype(
        np.int64)).to(params.device)
    sk_auto = sk_n_eval.long()[idx]
    a, k1 = _rgsw_samples(gen, params, sk_n_eval, (dg,), std)
    gpow = torch.tensor([pow(params.base_g, r + 1, q) for r in range(dg)],
                        dtype=torch.int64, device=params.device)[:, None]
    k1 = torch.remainder(k1 - torch.remainder(sk_auto * gpow, q), q)
    return torch.stack([a, k1], dim=-2).int()


def automorphism_acc(params: RGSWParams, g: int, auto_key, acc0, acc1):
    """(Automorphism :249): permute acc, keyswitch the a-component."""
    big_n, q = params.ring_dim, params.big_q
    idx = torch.from_numpy(eval_indices(big_n, g % (2 * big_n)).astype(
        np.int64)).to(params.device)
    a_g, b_g = acc0[..., idx], acc1[..., idx]
    dct = _fwd1(signed_digit_decompose_one(params, _inv1(a_g, params.basis)),
                params.basis)
    s = _key_sum(params, dct, auto_key)
    return s[..., 0, :].int(), torch.remainder(s[..., 1, :] + b_g,
                                               q).int()


def make_log_gen(big_n: int):
    """Map odd v in [1, 2N) -> signed discrete log base 5 (GetLogGen):
    v = 5^i -> i; v = -5^i -> -i (i>0); v = 2N-1 (-1) -> sentinel 2N."""
    m = 2 * big_n
    table = {}
    cur = 1
    for i in range(big_n // 2):
        table[cur] = i if i else 0
        table[(m - cur) % m] = -i if i else m    # -1 -> sentinel M
        cur = cur * 5 % m
    return table


def _lmkcdey_permute(big_n: int, a_vec) -> dict:
    """log_gen index -> the coordinates whose automorphism index w =
    (2N - a_i) | 1 (UNSCALED, rgsw-acc-lmkcdey.cpp EvalAcc :82: the 2N/q
    factor enters through the key monomials) has that discrete log."""
    m = 2 * big_n
    log_gen = make_log_gen(big_n)
    permute: dict = {}
    for i, ai in enumerate(np.asarray(a_vec, np.int64)):
        v = ((m - int(ai)) % m) | 0x1
        permute.setdefault(log_gen[v % m], []).append(i)
    return permute


def build_lmkcdey_schedule(params: RGSWParams, a_vec: np.ndarray,
                           num_auto_keys: int) -> np.ndarray:
    """Fixed-op-format LMKCDEY schedule for one public a-vector.

    The automorphism/external-product order is a pure function of the
    public a vector (rgsw-acc-lmkcdey.cpp EvalAcc :61-144), so it is
    precomputed on the host as an [L, 5] int32 array of uniform steps
    that `eval_acc_lmkcdey_scan` runs, batched over the gates.

    Step fields: (perm_sel, key_sel, pass0, use_sum, add_b) with
      perm_sel: row of lmkcdey_perm_table (0 identity, 1..w g=5^k,
                w+1 conjugation g=2N-5)
      key_sel : row of lmkcdey_key_bank (0 zero, 1..n RGSW(X^{s_j m}),
                n+1+k automorphism key k)
      new0 = pass0 ? perm(acc0) : sum_r NTT(digits)_r * key[r,0]
      new1 = (use_sum ? sum_r NTT(digits)_r * key[r,1] : 0)
             + (add_b ? perm(acc1) : 0)
    EP steps: (0, 1+j, 0, 1, 0); AUTO steps: (k, n+1+k, 0, 1, 1);
    the initial conjugation-permute: (w+1, 0, 1, 0, 1).
    """
    big_n = params.ring_dim
    m = 2 * big_n
    nh = big_n // 2
    n = params.n_lwe
    permute = _lmkcdey_permute(big_n, a_vec)

    ops = []

    def ep(j):
        ops.append((0, 1 + j, 0, 1, 0))

    def auto(k):                     # sigma_{5^k} with auto key k
        ops.append((k, n + 1 + k, 0, 1, 1))

    def auto0():                     # sigma_{2N-5} with auto key 0
        ops.append((num_auto_keys + 1, n + 1 + 0, 0, 1, 1))

    # initial conjugation permute of the accumulator (acc0 is zero at
    # entry, so permuting both components matches the reference's
    # acc1-only AutomorphismTransform)
    ops.append((num_auto_keys + 1, 0, 1, 0, 1))
    n_skips = 0
    for i in range(nh - 1, 0, -1):
        if -i in permute:
            if n_skips:
                auto(n_skips)
                n_skips = 0
            for j in permute[-i]:
                ep(j)
        n_skips += 1
        if n_skips == num_auto_keys or i == 1:
            auto(n_skips)
            n_skips = 0
    if m in permute:
        for j in permute[m]:
            ep(j)
    auto0()
    for i in range(nh - 1, 0, -1):
        if i in permute:
            if n_skips:
                auto(n_skips)
                n_skips = 0
            for j in permute[i]:
                ep(j)
        n_skips += 1
        if n_skips == num_auto_keys or i == 1:
            auto(n_skips)
            n_skips = 0
    if 0 in permute:
        for j in permute[0]:
            ep(j)
    return np.asarray(ops, np.int32)


LMK_NOOP = np.array([0, 0, 1, 0, 1], np.int32)    # identity schedule step


def lmkcdey_perm_table(params: RGSWParams, num_auto_keys: int) -> np.ndarray:
    """[w+2, N] EVAL gather rows: 0 identity, k=1..w sigma_{5^k},
    w+1 sigma_{2N-5}."""
    big_n = params.ring_dim
    m = 2 * big_n
    rows = [np.arange(big_n, dtype=np.int32)]
    for k in range(1, num_auto_keys + 1):
        rows.append(eval_indices(big_n, pow(5, k, m)))
    rows.append(eval_indices(big_n, (m - 5) % m))
    return np.stack(rows)


def lmkcdey_key_bank(params: RGSWParams, rgsw_keys: torch.Tensor,
                     auto_keys: dict, num_auto_keys: int) -> torch.Tensor:
    """[1+n+w+1, d2, 2, N] unified key bank: row 0 zero (no-op), rows
    1..n the RGSW keys, rows n+1+k the automorphism keys with their
    digitsG-1 rows placed at EVEN unified rows (a-component digits) and
    zero odd rows, so one masked step form serves both op kinds."""
    d2, big_n = params.digits_g2, params.ring_dim
    w = num_auto_keys
    bank = torch.zeros((1 + rgsw_keys.shape[0] + w + 1, d2, 2, big_n),
                       dtype=torch.int32, device=rgsw_keys.device)
    bank[1:1 + rgsw_keys.shape[0]] = rgsw_keys
    bank[1 + rgsw_keys.shape[0]:, 0::2] = torch.stack(
        [auto_keys[k] for k in range(w + 1)])
    return bank


def _lmkcdey_step(params: RGSWParams, key_bank, perm_table, step, acc0,
                  acc1):
    """One masked LMKCDEY step; step [..., 5] and perm_table int64 (see
    build_lmkcdey_schedule)."""
    q = params.big_q
    perm = perm_table[step[..., 0]]                          # [..., N]
    key = key_bank[step[..., 1]]                             # [..., d2,2,N]
    a_g = torch.gather(acc0.expand(perm.shape), -1, perm)
    b_g = torch.gather(acc1.expand(perm.shape), -1, perm)
    s = _key_sum(params, _step_digits(
        params, torch.stack([a_g, b_g], dim=-2)), key)
    acc0 = torch.where(step[..., 2, None] > 0, a_g.long(), s[..., 0, :])
    acc1 = torch.remainder(
        torch.where(step[..., 3, None] > 0, s[..., 1, :], 0)
        + torch.where(step[..., 4, None] > 0, b_g.long(), 0), q)
    return acc0.int(), acc1.int()


def _lmkcdey(rotate, params: RGSWParams, key_bank, perm_table, sched, acc0,
             acc1):
    lead = torch.broadcast_shapes(acc0.shape[:-1], acc1.shape[:-1],
                                  sched.shape[1:-1])
    steps = sched.expand((sched.shape[0],) + lead + (5,)).reshape(
        sched.shape[0], -1, 5).to(torch.int32).contiguous()
    return _unbatch(rotate(params, key_bank, (perm_table, steps),
                           *_batch_pair(acc0, acc1, lead)), lead)


def eval_acc_lmkcdey_scan(params: RGSWParams, key_bank, perm_table,
                          sched, acc0, acc1):
    """LMKCDEY blind rotation over uniform masked steps: one
    `blind_rotate_lmkcdey` launch on the card.

    sched: [L, ..., 5] int tensor on the accumulator's device (leading
    batch dims of acc broadcast; each gate carries its own padded
    schedule). See build_lmkcdey_schedule.
    """
    return _lmkcdey(blind_rotate.blind_rotate_lmkcdey, params, key_bank,
                    perm_table, sched, acc0, acc1)


def _eval_acc_lmkcdey_scan_steps(params: RGSWParams, key_bank, perm_table,
                                 sched, acc0, acc1):
    """eval_acc_lmkcdey_scan as the per-step loop on any device (the
    unfused chain)."""
    return _lmkcdey(blind_rotate._lmkcdey_ref, params, key_bank, perm_table,
                    sched, acc0, acc1)


def eval_acc_lmkcdey(params: RGSWParams, rgsw_keys, auto_keys: dict,
                     num_auto_keys: int, acc0, acc1, a_vec: np.ndarray):
    """LMKCDEY blind rotation for ONE ciphertext (host-scheduled, the
    reference's loop; EvalAcc :68)."""
    big_n = params.ring_dim
    m = 2 * big_n
    nh = big_n // 2
    permute = _lmkcdey_permute(big_n, a_vec)
    gen = 5
    n_skips = 0
    # reference applies AutomorphismTransform(M - gen) to acc[1] only
    idx = torch.from_numpy(eval_indices(big_n, (m - gen) % m).astype(
        np.int64)).to(params.device)
    acc1 = acc1[..., idx]

    def auto(g, key):
        nonlocal acc0, acc1
        acc0, acc1 = automorphism_acc(params, g, key, acc0, acc1)

    def eps(js):
        nonlocal acc0, acc1
        for j in js:
            acc0, acc1 = external_product_replace(params, rgsw_keys[j],
                                                  acc0, acc1)

    for sign in (-1, 1):
        if sign == 1:
            auto((m - gen) % m, auto_keys[0])
        for i in range(nh - 1, 0, -1):
            if sign * i in permute:
                if n_skips:
                    auto(pow(gen, n_skips, m), auto_keys[n_skips])
                    n_skips = 0
                eps(permute[sign * i])
            n_skips += 1
            if n_skips == num_auto_keys or i == 1:
                auto(pow(gen, n_skips, m), auto_keys[n_skips])
                n_skips = 0
        last = m if sign == -1 else 0
        if last in permute:
            eps(permute[last])
    return acc0, acc1
