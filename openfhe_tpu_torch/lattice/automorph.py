"""Automorphism index tables (host precompute).

Counterpart of `openfhe_tpu/lattice/automorph.py`, copied (reference
analog: PolyImpl::AutomorphismTransform and its precomputed-index
variant, poly-impl.h). The automorphism sigma_g : a(X) -> a(X^g) is a
gather along the last axis in EVAL form (`eval_indices`; the context
keeps one index tensor per g on its device and gathers with
`torch.index_select`) or a signed gather on COEFF words (`coeff_indices`).

EVAL layout (ops/ntt.py): slot j holds a(psi^(2*brv(j)+1)).
"""

from __future__ import annotations

import functools

import numpy as np

from openfhe_tpu_torch.lattice.basis import _bitrev_indices


@functools.lru_cache(maxsize=None)
def eval_indices(n: int, g: int) -> np.ndarray:
    """Gather table: out_eval[j] = in_eval[idx[j]] implements sigma_g."""
    two_n = 2 * n
    rev = _bitrev_indices(n)
    # exponent stored at slot j
    e = (2 * rev.astype(np.int64) + 1) % two_n
    # sigma_g out(psi^e) = in(psi^(g*e)); find slot j' with e(j') = g*e(j)
    target = (g * e) % two_n
    # slot for exponent t: j' with 2*brv(j')+1 = t  ->  brv(j') = (t-1)/2
    inv_rev = np.argsort(rev)
    jprime = inv_rev[((target - 1) // 2).astype(np.int64)]
    return jprime.astype(np.int32)


@functools.lru_cache(maxsize=None)
def coeff_indices(n: int, g: int) -> tuple:
    """(idx, neg_mask): out[r] = (-1)^neg[r] * in[idx[r]] implements sigma_g
    on natural-order coefficients of a negacyclic ring element."""
    two_n = 2 * n
    ginv = pow(g, -1, two_n)
    r = np.arange(n, dtype=np.int64)
    i0 = (r * ginv) % two_n
    neg = i0 >= n
    idx = np.where(neg, i0 - n, i0)
    return idx.astype(np.int32), neg


def rotation_generator(n: int) -> int:
    """Generator for slot rotations: 5 generates the cyclic part of
    Z_{2N}^* / {+-1} (conjugation is g = 2N - 1)."""
    return 5


def rotation_automorphism_index(rot: int, n: int) -> int:
    """Slot rotation by `rot` (positive: to the left) -> automorphism
    exponent g = 5^rot mod 2N (reference: cryptocontext.h
    FindAutomorphismIndex)."""
    two_n = 2 * n
    return pow(5, rot % (n // 2), two_n) if rot >= 0 else pow(
        pow(5, -1, two_n), (-rot) % (n // 2), two_n)


CONJUGATION = "conj"


def conjugation_index(n: int) -> int:
    """Automorphism exponent for complex conjugation (2N - 1)."""
    return 2 * n - 1
