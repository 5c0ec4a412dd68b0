"""Composite-Q RGSW / GINX accumulator for the STD192-class parameter sets
(Q from 2^32 up to about 2^40).

Counterpart of `openfhe_tpu/binfhe/rgsw_wide.py` (reference analog: the
rgsw-acc-cggi.cpp blind rotation, which OpenFHE runs on 64-bit words for
the binfhecontext.cpp rows with 34-39 bits of Q).

The ring is the JAX package's: two NTT-friendly towers Q = q1 * q2, each
below 2^31, so every ring operation is per-tower residue arithmetic and the
NTTs are the port's `ops/ntt.py` calls (kernel m, `csrc/ntt_small.cu`, on
the card at N <= 2048) outside the blind rotation. Only the signed gadget
decomposition needs the integer value of a coefficient. The JAX package
rebuilds it as a (hi, lo) uint32 pair (its lanes have no 64-bit words);
here it is one int64, x = x1 + q1 * t with t = (x2 - x1) * q1^-1 mod q2
(Garner), and the balanced base-2^g digits are int64 shifts of the
centred value. The digits and the residues are the JAX package's words.

Layouts: an accumulator is [..., 2, N] (tower, slots) in EVAL; the GINX
key is [n, 2, d2, 2, 2, N]: coordinate, CMUX key, gadget row, (a, b) pair,
tower, slots (the JAX keygen stacks the pair at axis -3, before the tower
axis, and its blind rotation reads it so).

A blind rotation (`eval_acc_cggi_wide`) is one launch of
`blind_rotate.blind_rotate_cggi_wide` on the card (`csrc/blind_rotate.cu`:
the n steps of every gate in a cluster of two blocks, a tower a block),
the counterpart of the JAX package's `lax.scan` with kernel m in it. Its
plain twin, on the CPU, is the per-step loop `_wide_step` batched over the
gates: each step one inverse NTT of both accumulator halves, the Garner
digits, one forward NTT of the [..., d2, 2, N] digits and the key products
in plain int64 torch. `_eval_acc_cggi_wide_steps` runs that loop on any
device (on the card: two kernel-m launches a step and plain torch around
them), the yardstick the kernel is held against. Every modular sum is
exact, so the words equal the JAX package's add_mod trees.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from openfhe_tpu_torch.binfhe import blind_rotate
from openfhe_tpu_torch.lattice.basis import Basis, _bitrev_indices, make_basis
from openfhe_tpu_torch.math import nbtheory, sampling
from openfhe_tpu_torch.math.modops import to_u32
from openfhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv


@dataclasses.dataclass(frozen=True)
class RGSWWideParams:
    """RGSW parameters over a 2-tower composite modulus Q = q1 * q2."""
    basis: Basis                  # [2] towers at ring dim N
    psi_pow: torch.Tensor         # [2, 2N] int64 per-tower psi powers
    eval_exp: torch.Tensor        # [N] int64 slot exponents (shared)
    q_col: torch.Tensor           # [2, 1] int64 moduli
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
        return 2 * (self.digits_g - 1)

    @property
    def device(self) -> torch.device:
        return self.basis.device

    @property
    def moduli(self) -> tuple:
        return self.basis.moduli

    def replace(self, **changes) -> "RGSWWideParams":
        return dataclasses.replace(self, **changes)


def make_rgsw_wide_params(n_lwe: int, ring_dim: int, q_bits: int,
                          q_lwe: int, base_g: int,
                          device="cpu") -> RGSWWideParams:
    """Q = q1 * q2 with about q_bits bits, both = 1 mod 2N (the JAX
    package's choice: q1 the prime below 2^(ceil(q_bits / 2) + 1), q2 the
    one below 2^floor(q_bits / 2))."""
    hi_bits = (q_bits + 1) // 2
    lo_bits = q_bits - hi_bits
    q1 = nbtheory.previous_prime(1 << (hi_bits + 1), 2 * ring_dim)
    q2 = nbtheory.previous_prime(1 << lo_bits, 2 * ring_dim)
    if q2 == q1:
        q2 = nbtheory.previous_prime(q2, 2 * ring_dim)
    big_q = q1 * q2
    basis = make_basis([q1, q2], ring_dim, device=device)
    digits_g = int(math.ceil(math.log(big_q) / math.log(base_g)))
    # balanced digits need B^d >= 2Q, so that the residual after d shifts
    # vanishes for every |x| <= Q/2
    if base_g ** digits_g < 2 * big_q:
        digits_g += 1
    rev = _bitrev_indices(ring_dim)
    psi_br = to_u32(basis.psi_br).astype(np.int64)
    pows = np.ones((2, 2 * ring_dim), np.int64)
    for t, q in enumerate((q1, q2)):
        psi = int(psi_br[t, rev[1]]) if ring_dim > 1 else 1
        for i in range(1, 2 * ring_dim):
            pows[t, i] = pows[t, i - 1] * psi % q
    eval_exp = (2 * rev.astype(np.int64) + 1) % (2 * ring_dim)
    return RGSWWideParams(
        basis=basis, psi_pow=torch.from_numpy(pows).to(device),
        eval_exp=torch.from_numpy(eval_exp).to(device),
        q_col=torch.tensor([[q1], [q2]], dtype=torch.int64, device=device),
        n_lwe=n_lwe, q_lwe=q_lwe, big_q=big_q, base_g=base_g,
        digits_g=digits_g)


# ---------------------------------------------------------------------------
# Garner reconstruction and the balanced digits
# ---------------------------------------------------------------------------

def garner(params: RGSWWideParams, x_res: torch.Tensor) -> torch.Tensor:
    """RNS residues [..., 2, N] -> x in [0, Q) as int64 [..., N] (the JAX
    package's `garner_pair`, whose (hi, lo) pair is x's two 32-bit
    halves)."""
    q1, q2 = params.moduli
    inv = pow(q1 % q2, -1, q2)
    x1 = x_res[..., 0, :].long()
    x2 = x_res[..., 1, :].long()
    t = torch.remainder((x2 - x1 % q2) * inv, q2)
    return x1 + q1 * t


def signed_digits(params: RGSWWideParams, x: torch.Tensor,
                  drop_first: bool = True) -> list:
    """Balanced base-2^g digits of x in [0, Q) centred to (-Q/2, Q/2]: a
    list of int64 [..., N], digit 0 dropped for the approximate
    decomposition (rgsw-acc.cpp SignedDigitDecompose; the JAX package's
    `signed_digits_pair`)."""
    g = int(math.log2(params.base_g))
    half = params.base_g >> 1
    mask = params.base_g - 1
    x = torch.where(x >= params.big_q >> 1, x - params.big_q, x)
    out = []
    for j in range(params.digits_g):
        r = ((x & mask) ^ half) - half
        if not (drop_first and j == 0):
            out.append(r)
        x = (x - r) >> g
    return out


def digits_to_residues(params: RGSWWideParams, digits) -> torch.Tensor:
    """[list of int64 [..., N]] -> [..., ndig, 2, N] int32 residues."""
    d = torch.stack(digits, dim=-2).unsqueeze(-2)      # [..., ndig, 1, N]
    return torch.where(d < 0, d + params.q_col, d).int()


def signed_digit_decompose_wide(params: RGSWWideParams, c0: torch.Tensor,
                                c1: torch.Tensor) -> torch.Tensor:
    """(c0, c1) [..., 2, N] residues -> [..., d2, 2, N]: even rows from c0,
    odd from c1, first digit dropped."""
    return _decompose_pair(params, torch.stack([c0, c1], dim=-3))


def _decompose_pair(params: RGSWWideParams, p: torch.Tensor) -> torch.Tensor:
    """The interleaved digits of the pair p [..., 2 (c0, c1), 2, N]."""
    digs = signed_digits(params, garner(params, p))   # each [..., 2, N]
    return digits_to_residues(params, [d[..., c, :] for d in digs
                                       for c in (0, 1)])


# ---------------------------------------------------------------------------
# ring helpers (tower-aware)
# ---------------------------------------------------------------------------

def monomial_eval_wide(params: RGSWWideParams, t) -> torch.Tensor:
    """EVAL-domain X^t per tower: int64 [..., 2, N]."""
    two_n = 2 * params.ring_dim
    t = torch.as_tensor(t, dtype=torch.int64, device=params.device)
    exps = (t[..., None] * params.eval_exp) % two_n      # [..., N]
    return torch.stack([params.psi_pow[i][exps] for i in range(2)], dim=-2)


def keygen_cggi_pair_wide(gen: torch.Generator, params: RGSWWideParams,
                          sk_n_eval: torch.Tensor, s_lwe: torch.Tensor,
                          std: float = 3.19) -> torch.Tensor:
    """CGGI bootstrapping key [n, 2, d2, 2, 2, N] int32 EVAL: coordinate,
    CMUX key (key 0 encrypts [s_i == 1], key 1 [s_i == -1]), gadget row,
    (a, b) pair, tower, slots. sk_n_eval: [2, N] EVAL residues of the ring
    secret."""
    b, q = params.basis, params.q_col
    n, big_n, d2 = params.n_lwe, params.ring_dim, params.digits_g2
    a = sampling.uniform_residues(gen, b, lead_shape=(n, 2, d2))
    e = sampling.discrete_gaussian(gen, (n, 2, d2, big_n), std)
    a_eval = ntt_fwd(a, b).long()
    e_eval = ntt_fwd(sampling.to_residues(e, b), b).long()
    b_eval = torch.remainder(e_eval + a_eval * sk_n_eval.long(), q)
    s = s_lwe.long()
    mbits = torch.stack([s == 1, s == -1], dim=1)              # [n, 2]
    gpow = torch.tensor(
        [[pow(params.base_g, r // 2 + 1, params.big_q) % qt
          for qt in params.moduli] for r in range(d2)],
        dtype=torch.int64, device=params.device)[..., None]     # [d2, 2, 1]
    add = torch.where(mbits[:, :, None, None, None], gpow, 0)  # [n,2,d2,2,1]
    even = (torch.arange(d2, device=params.device) % 2 == 0)[:, None, None]
    a_out = torch.remainder(a_eval + torch.where(even, add, 0), q)
    b_out = torch.remainder(b_eval + torch.where(even, 0, add), q)
    return torch.stack([a_out, b_out], dim=-3).int()


def _wide_step(params: RGSWWideParams, key: torch.Tensor, ix: torch.Tensor,
               acc: torch.Tensor) -> torch.Tensor:
    """One GINX step on the pair acc [B, 2 (acc0, acc1), 2, N] int64: key
    [2, d2, 2, 2, N] int64 of the coordinate, ix [B] its monomial exponent.
    Sums are reduced once: d2 <= 16 products of two residues, then two
    products of a residue and X^+-ix - 1, stay below 2^63 for towers below
    2^29 (every wide set's are below 2^26)."""
    b, q = params.basis, params.q_col
    two_n = 2 * params.ring_dim
    coeff = ntt_inv(acc.int(), b)                            # one call
    dct = ntt_fwd(_decompose_pair(params, coeff), b).long()  # [B, d2, 2, N]
    # t[B, k, c] = sum_r dct[B, r] * key[k, r, c] mod q
    t = torch.remainder((dct[:, None, :, None] * key).sum(2), q)
    mono = monomial_eval_wide(params, torch.stack(
        [ix, torch.remainder(two_n - ix, two_n)], dim=-1))  # [B, 2k, 2, N]
    return torch.remainder(acc + (t * (mono - 1).unsqueeze(2)).sum(1), q)


def _cggi_wide(rotate, params: RGSWWideParams, bskey: torch.Tensor, acc0,
               acc1, a_lwe: torch.Tensor):
    lead = torch.broadcast_shapes(acc0.shape[:-2], acc1.shape[:-2],
                                  a_lwe.shape[:-1])
    big_n = params.ring_dim
    a = a_lwe.expand(lead + a_lwe.shape[-1:]).reshape(-1, a_lwe.shape[-1])
    acc = [x.expand(lead + (2, big_n)).reshape(-1, 2, big_n).contiguous()
           for x in (acc0, acc1)]                             # [B, 2, N]
    out = rotate(params, bskey, blind_rotate.cggi_idx(params, a), *acc)
    return tuple(x.reshape(lead + (2, big_n)) for x in out)


def eval_acc_cggi_wide(params: RGSWWideParams, bskey: torch.Tensor, acc0,
                       acc1, a_lwe: torch.Tensor):
    """GINX blind rotation over the composite-Q ring.

    acc0 / acc1: [..., 2, N] EVAL; a_lwe: [..., n] mod q_lwe; bskey
    [n, 2, d2, 2, 2, N] from `keygen_cggi_pair_wide`. The n steps of every
    gate run as one `blind_rotate_cggi_wide` launch on the card, the
    per-step loop on the CPU (`blind_rotate.py`)."""
    return _cggi_wide(blind_rotate.blind_rotate_cggi_wide, params, bskey,
                      acc0, acc1, a_lwe)


def _eval_acc_cggi_wide_steps(params: RGSWWideParams, bskey: torch.Tensor,
                              acc0, acc1, a_lwe: torch.Tensor):
    """eval_acc_cggi_wide as the per-step loop on any device (on the card
    two kernel-m calls a step and plain torch around them)."""
    why = blind_rotate._unsupported(params, blind_rotate.WIDE_FORM)
    if why:
        raise ValueError(f"the wide blind rotation {why}")
    return _cggi_wide(blind_rotate._cggi_wide_ref, params, bskey, acc0,
                      acc1, a_lwe)
