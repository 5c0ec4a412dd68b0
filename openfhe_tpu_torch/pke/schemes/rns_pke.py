"""RNS PKE core: keygen / encrypt-zero / decrypt inner products.

Counterpart of `openfhe_tpu/pke/schemes/rns_pke.py` (reference analog:
base-pke.cpp:47-98 and rns-pke.cpp), with the CKKS noise scale 1. Random
draws come from the caller's `torch.Generator`.
"""

from __future__ import annotations

import torch

from openfhe_tpu_torch.lattice.basis import Basis
from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.math import sampling
from openfhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from openfhe_tpu_torch.pke.constants import SecretKeyDist
from openfhe_tpu_torch.pke.keys import KeyPair, PrivateKey, PublicKey


def _small_eval(small: torch.Tensor, basis: Basis) -> torch.Tensor:
    """A small signed polynomial lifted to `basis` in EVAL form."""
    return ntt_fwd(sampling.to_residues(small, basis), basis)


def keygen(gen: torch.Generator, basis_qp: Basis, key_tag: str,
           secret_key_dist=SecretKeyDist.UNIFORM_TERNARY,
           sigma: float = sampling.DEFAULT_SIGMA) -> KeyPair:
    """RLWE key generation: s small; pk = (b, a) over QP with
    b = e - a*s."""
    n = basis_qp.ring_dim
    if secret_key_dist == SecretKeyDist.GAUSSIAN:
        s_small = sampling.discrete_gaussian(gen, (n,), sigma)
    elif secret_key_dist == SecretKeyDist.SPARSE_TERNARY:
        s_small = sampling.ternary(gen, (n,), hamming_weight=192)
    else:
        s_small = sampling.ternary(gen, (n,))
    s_qp = _small_eval(s_small, basis_qp)
    a = sampling.uniform_residues(gen, basis_qp)
    e = _small_eval(sampling.discrete_gaussian(gen, (n,), sigma), basis_qp)
    b = mo.sub_mod(e, mo.mul_mod(a, s_qp, basis_qp.q), basis_qp.q)
    return KeyPair(public_key=PublicKey(b=b, a=a, key_tag=key_tag),
                   secret_key=PrivateKey(s_qp=s_qp, key_tag=key_tag))


def encrypt_zero_pk(gen: torch.Generator, pk: PublicKey, basis_ql: Basis,
                    secret_key_dist=SecretKeyDist.UNIFORM_TERNARY):
    """(c0, c1) = (b*u + e0, a*u + e1) over Q_l, EVAL format."""
    n = basis_ql.ring_dim
    k = basis_ql.k
    if secret_key_dist == SecretKeyDist.GAUSSIAN:
        u_small = sampling.discrete_gaussian(gen, (n,))
    else:
        u_small = sampling.ternary(gen, (n,))
    u = _small_eval(u_small, basis_ql)
    e0 = _small_eval(sampling.discrete_gaussian(gen, (n,)), basis_ql)
    e1 = _small_eval(sampling.discrete_gaussian(gen, (n,)), basis_ql)
    c0 = mo.add_mod(mo.mul_mod(pk.b[:k], u, basis_ql.q), e0, basis_ql.q)
    c1 = mo.add_mod(mo.mul_mod(pk.a[:k], u, basis_ql.q), e1, basis_ql.q)
    return c0, c1


def encrypt_zero_sk(gen: torch.Generator, sk: PrivateKey, basis_ql: Basis):
    """(c0, c1) = (e - a*s, a) over Q_l, EVAL format."""
    n = basis_ql.ring_dim
    k = basis_ql.k
    a = sampling.uniform_residues(gen, basis_ql)
    e = _small_eval(sampling.discrete_gaussian(gen, (n,)), basis_ql)
    c0 = mo.sub_mod(e, mo.mul_mod(a, sk.s_qp[:k], basis_ql.q), basis_ql.q)
    return c0, a


def decrypt_core(elements, sk: PrivateKey, basis_ql: Basis) -> torch.Tensor:
    """b = c0 + c1*s + c2*s^2 + ... -> COEFF residues [k, N]."""
    k = elements[0].shape[-2]
    s = sk.s_qp[:k]
    acc = elements[0]
    s_pow = s
    for i, c in enumerate(elements[1:]):
        acc = mo.add_mod(acc, mo.mul_mod(c, s_pow, basis_ql.q), basis_ql.q)
        if i + 2 < len(elements):
            s_pow = mo.mul_mod(s_pow, s, basis_ql.q)
    return ntt_inv(acc, basis_ql)
