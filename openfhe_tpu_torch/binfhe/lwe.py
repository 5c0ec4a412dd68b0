"""LWE scheme: keygen, encryption, modulus and key switching.

Counterpart of `openfhe_tpu/binfhe/lwe.py` (reference analog: OpenFHE's
src/binfhe/lib/lwe-pke.cpp: KeyGen :48, PubKeyGen :75, Encrypt :101,
Decrypt, ModSwitch :242 RoundqQ, KeySwitchGen :252, KeySwitch :323,
SwitchCTtoqn :153, NoiselessEmbedding :349).

LWE ciphertexts are batched int32 tensors on one device (`[..., n]` for
a, `[...]` for b), holding the JAX package's uint32 words, for every
modulus below 2^31. A sample extracted from a composite-Q ring
(`rgsw_wide.py`, Q up to about 2^40) holds int64 words until it is
switched down. Arithmetic widens to int64. The JAX package's modular
sums are pairwise add_mod trees; any exact modular sum gives the same
words, so here they are int64 sums reduced once. Mod switching is the
exact rounding (v * q_to + floor(q_from / 2)) // q_from mod q_to, whose
words equal both of the JAX package's paths: int64 on the ciphertext's
device while the product fits, else Python integers on the host, as the
JAX package does past 62 bits.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from openfhe_tpu_torch.math import sampling

# elements of one gathered chunk in `key_switch` (int32: 128 MB)
KS_CHUNK = 1 << 25


@dataclasses.dataclass(frozen=True)
class LWECiphertext:
    a: torch.Tensor                 # [..., n] int32
    b: torch.Tensor                 # [...] int32
    modulus: int = 0
    pt_modulus: int = 4

    def replace(self, **changes) -> "LWECiphertext":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class LWEPrivateKey:
    s: torch.Tensor                 # [n] int32 in {-1, 0, 1} (or small gauss)

    def replace(self, **changes) -> "LWEPrivateKey":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class LWEPublicKey:
    A: torch.Tensor                 # [N, N] int32 mod Q
    v: torch.Tensor                 # [N] int32: A s + e

    def replace(self, **changes) -> "LWEPublicKey":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class LWESwitchingKey:
    """KS key: encryptions of j * B^k * sN_i under the small key.

    a: [N, baseKS, d, n] int32, b: [N, baseKS, d] int32, all mod qKS.
    """
    a: torch.Tensor
    b: torch.Tensor
    mod_ks: int = 0
    base_ks: int = 0

    def replace(self, **changes) -> "LWESwitchingKey":
        return dataclasses.replace(self, **changes)


def words(m, device) -> torch.Tensor:
    """Messages or words (numpy, list, int or tensor) as int32 on `device`."""
    if isinstance(m, torch.Tensor):
        return m.to(device=device, dtype=torch.int32)
    return torch.from_numpy(np.asarray(m, np.int64).astype(np.int32)).to(
        device)


def _signed_dot_mod(a: torch.Tensor, s: torch.Tensor, q: int) -> torch.Tensor:
    """sum_i a_i * s_i mod q along the last axis (int32 result)."""
    return torch.remainder((a.long() * s.long()).sum(-1), q).int()


def key_gen(gen: torch.Generator, n: int,
            dist: str = "ternary") -> LWEPrivateKey:
    """(lwe-pke.cpp:48) ternary (or gaussian) secret of dimension n."""
    if dist == "gaussian":
        return LWEPrivateKey(s=sampling.discrete_gaussian(gen, (n,)))
    return LWEPrivateKey(s=sampling.ternary(gen, (n,)))


def pub_key_gen(gen: torch.Generator, sk: LWEPrivateKey, q: int,
                std: float = 3.19) -> LWEPublicKey:
    """(lwe-pke.cpp:75 PubKeyGen) pk = (A, v = A s + e) at dimension N."""
    n = sk.s.shape[-1]
    A = torch.randint(0, q, (n, n), generator=gen, device=gen.device,
                      dtype=torch.int32)
    e = sampling.discrete_gaussian(gen, (n,), std)
    v = torch.remainder(_signed_dot_mod(A, sk.s, q).long() + e, q).int()
    return LWEPublicKey(A=A, v=v)


def key_gen_pair(gen: torch.Generator, n: int, q: int,
                 dist: str = "ternary"):
    """(lwe-pke.cpp:62 KeyGenPair) -> (pk, skN)."""
    sk = key_gen(gen, n, dist)
    return pub_key_gen(gen, sk, q), sk


def _message_term(m: torch.Tensor, q: int, p: int) -> torch.Tensor:
    return (m.long() % p) * (q // p)


def encrypt_pub(gen: torch.Generator, pk: LWEPublicKey, m, q: int,
                p: int = 4, std: float = 3.19) -> LWECiphertext:
    """(lwe-pke.cpp:112 EncryptN) public-key LWE encryption at dimension N:
    a = A^T s' + e_a,  b = m*(q/p) + <v, s'> + e_b with ephemeral ternary
    s'. A^T s' is one float64 product: |A^T s'| < N * 2^31 < 2^53, so it is
    exact."""
    m = words(m, pk.A.device)
    n = pk.v.shape[-1]
    sp = sampling.ternary(gen, tuple(m.shape) + (n,))
    e_a = sampling.discrete_gaussian(gen, tuple(m.shape) + (n,), std)
    e_b = sampling.discrete_gaussian(gen, tuple(m.shape), std)
    asp = torch.matmul(sp.double(), pk.A.double()).round().long()
    a = torch.remainder(asp + e_a, q).int()
    b = torch.remainder(_message_term(m, q, p) + e_b
                        + _signed_dot_mod(pk.v, sp, q).long(), q).int()
    return LWECiphertext(a=a, b=b, modulus=q, pt_modulus=p)


def encrypt(gen: torch.Generator, sk: LWEPrivateKey, m, q: int, p: int = 4,
            std: float = 3.19) -> LWECiphertext:
    """b = a*s + e + m*(q/p) (lwe-pke.cpp:101). `m` may be batched."""
    m = words(m, sk.s.device)
    n = sk.s.shape[-1]
    a = torch.randint(0, q, tuple(m.shape) + (n,), generator=gen,
                      device=gen.device, dtype=torch.int32)
    e = sampling.discrete_gaussian(gen, tuple(m.shape), std)
    b = torch.remainder(_message_term(m, q, p) + e
                        + _signed_dot_mod(a, sk.s, q).long(), q).int()
    return LWECiphertext(a=a, b=b, modulus=q, pt_modulus=p)


def decrypt(sk: LWEPrivateKey, ct: LWECiphertext) -> np.ndarray:
    """m = round(p/q * (b - a*s)) mod p (lwe-pke.cpp Decrypt), on the host."""
    q, p = ct.modulus, ct.pt_modulus
    r = torch.remainder(ct.b.long() - _signed_dot_mod(ct.a, sk.s, q).long(),
                        q)
    r_host = r.cpu().numpy().astype(np.int64)
    return ((r_host * p + q // 2) // q) % p


def noiseless_embedding(n: int, m, q: int, p: int = 4,
                        device="cpu") -> LWECiphertext:
    m = words(m, device)
    return LWECiphertext(
        a=torch.zeros(tuple(m.shape) + (n,), dtype=torch.int32,
                      device=m.device),
        b=_message_term(m, q, p).int(), modulus=q, pt_modulus=p)


def eval_add(c1: LWECiphertext, c2: LWECiphertext) -> LWECiphertext:
    q = c1.modulus
    return c1.replace(a=torch.remainder(c1.a.long() + c2.a, q).int(),
                      b=torch.remainder(c1.b.long() + c2.b, q).int())


def eval_sub(c1: LWECiphertext, c2: LWECiphertext) -> LWECiphertext:
    q = c1.modulus
    return c1.replace(a=torch.remainder(c1.a.long() - c2.a, q).int(),
                      b=torch.remainder(c1.b.long() - c2.b, q).int())


def eval_not(ct: LWECiphertext) -> LWECiphertext:
    """(binfhe-base-scheme.cpp EvalNOT): (q/4 - b, -a)."""
    q = ct.modulus
    return ct.replace(a=torch.remainder(-ct.a.long(), q).int(),
                      b=torch.remainder(q // 4 - ct.b.long(), q).int())


def add_const(ct: LWECiphertext, c: int) -> LWECiphertext:
    """b + c mod the ciphertext's modulus (c may be negative)."""
    return ct.replace(b=torch.remainder(ct.b.long() + c, ct.modulus).int())


def reduce_mod(ct: LWECiphertext, q: int) -> LWECiphertext:
    """The words of a and b reduced mod q, now read mod q."""
    return ct.replace(a=torch.remainder(ct.a, q), b=torch.remainder(ct.b, q),
                      modulus=q)


def _check_narrow(*moduli) -> None:
    """Switching keys hold int32 words: every qKS of the parameter sets
    (and of custom contexts, wide ones included) is below 2^31."""
    if any(int(m) >= 1 << 31 for m in moduli):
        raise ValueError("a key-switching modulus of 2^31 or more does not "
                         "fit the int32 words of a switching key")


def word_dtype(q: int) -> torch.dtype:
    """The dtype of an LWE word mod q: int32 below 2^31, else int64."""
    return torch.int32 if int(q) < 1 << 31 else torch.int64


def mod_switch(q_to: int, ct: LWECiphertext) -> LWECiphertext:
    """Round(v * q_to / q_from) per entry (lwe-pke.cpp:242 RoundqQ).

    (v * q_to + floor(q_from / 2)) // q_from equals (2 v q_to + q_from) //
    (2 q_from) for odd and even q_from alike. int64 on the device while
    (q_from - 1) * q_to + q_from / 2 stays below 2^63 (every STD192-class
    switch: Q < 2^40, qKS <= 2^17); past it, exact Python integers on the
    host (a custom 50-bit Q into a 21-bit qKS)."""
    q_from, q_to = int(ct.modulus), int(q_to)
    half = q_from >> 1
    dtype = word_dtype(q_to)
    fits = (q_from - 1) * q_to + half < 1 << 63

    def rq(v):
        if fits:
            return torch.remainder((v.long() * q_to + half) // q_from,
                                   q_to).to(dtype)
        x = v.cpu().numpy().astype(np.int64).astype(object)
        r = ((x * q_to + half) // q_from % q_to).astype(np.int64)
        return torch.from_numpy(np.asarray(r, np.int64).reshape(
            tuple(v.shape))).to(device=v.device, dtype=dtype)

    return ct.replace(a=rq(ct.a), b=rq(ct.b), modulus=q_to)


def _jbk_table(q_ks: int, base_ks: int, d: int) -> np.ndarray:
    """j * B^k mod qKS, [base_ks, d]."""
    jbk = np.zeros((base_ks, d), np.int64)
    val = 1
    for kk in range(d):
        for j in range(base_ks):
            jbk[j, kk] = (j * val) % q_ks
        val = (val * base_ks) % q_ks
    return jbk


def ks_digits(q_ks: int, base_ks: int) -> int:
    return int(math.ceil(math.log(q_ks) / math.log(base_ks)))


def key_switch_gen(gen: torch.Generator, sk: LWEPrivateKey,
                   sk_n: LWEPrivateKey, q_ks: int, base_ks: int,
                   std: float = 3.19) -> LWESwitchingKey:
    """(lwe-pke.cpp:252): ks[i][j][k] encrypts j * B^k * sN_i under sk."""
    _check_narrow(q_ks)
    big_n = sk_n.s.shape[-1]
    n = sk.s.shape[-1]
    d = ks_digits(q_ks, base_ks)
    dev = gen.device
    a = torch.randint(0, q_ks, (big_n, base_ks, d, n), generator=gen,
                      device=dev, dtype=torch.int32)
    e = sampling.discrete_gaussian(gen, (big_n, base_ks, d), std)
    jbk = torch.from_numpy(_jbk_table(q_ks, base_ks, d)).to(dev)
    msg = jbk[None] * sk_n.s.long()[:, None, None]          # sN_i * j B^k
    b = torch.remainder(msg + e + _signed_dot_mod(a, sk.s, q_ks).long(),
                        q_ks).int()
    return LWESwitchingKey(a=a, b=b, mod_ks=q_ks, base_ks=base_ks)


def key_switch(ks: LWESwitchingKey, ct: LWECiphertext) -> LWECiphertext:
    """(lwe-pke.cpp:323): subtract the keyed digits of each a_i.

    The a-rows that the digits select are gathered and summed a few
    ciphertexts at a time (`KS_CHUNK` words per gather), never the whole
    [..., N, d, n] at once; sums of N * d words below 2^31 fit int64."""
    q, base = ks.mod_ks, ks.base_ks
    big_n, _, d, n = ks.a.shape
    dev = ks.a.device
    lead = tuple(ct.a.shape[:-1])
    at = ct.a.long().reshape(-1, big_n)
    digs = []
    for _ in range(d):
        digs.append(at % base)
        at = at // base
    digits = torch.stack(digs, dim=-1)                      # [R, N, d]
    i_idx = torch.arange(big_n, device=dev)[:, None]
    k_idx = torch.arange(d, device=dev)[None, :]
    flat = ((i_idx * base + digits) * d + k_idx).reshape(digits.shape[0], -1)
    b_sum = ks.b.reshape(-1)[flat].sum(-1, dtype=torch.int64)
    a_rows = ks.a.reshape(-1, n)
    step = max(1, KS_CHUNK // (big_n * d * n))
    a_sum = torch.cat([a_rows[flat[r:r + step]].sum(-2, dtype=torch.int64)
                       for r in range(0, flat.shape[0], step)])
    a = torch.remainder(-a_sum, q).int().reshape(lead + (n,))
    b = torch.remainder(ct.b.long().reshape(-1) - b_sum, q).int()
    return LWECiphertext(a=a, b=b.reshape(lead), modulus=q,
                         pt_modulus=ct.pt_modulus)


def switch_ct_to_qn(ks: LWESwitchingKey, q: int,
                    ct: LWECiphertext) -> LWECiphertext:
    """ModSwitch(qKS) -> KeySwitch -> ModSwitch(q) (lwe-pke.cpp:153)."""
    ct_ms = mod_switch(ks.mod_ks, ct)
    ct_ks = key_switch(ks, ct_ms)
    return mod_switch(q, ct_ks)
