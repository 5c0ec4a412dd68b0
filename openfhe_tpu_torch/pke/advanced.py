"""AdvancedSHE: many-operand trees and rotation ladders.

Counterpart of the first part of `openfhe_tpu/pke/advanced.py` (reference
analog: base-advancedshe.cpp EvalAddMany / EvalMultMany binary trees,
EvalSum via rotation ladders, EvalInnerProduct). Each function takes the
context `cc` and calls its public ops, so on a CUDA context every rotation
is one fused key switch. The polynomial and Chebyshev series,
EvalLinearWSum and EvalMerge need plaintext multiplies and are not ported
yet.
"""

from __future__ import annotations

import math

from openfhe_tpu_torch.pke.ciphertext import Ciphertext


def _tree(op, cts) -> Ciphertext:
    """Pairwise binary tree of `op` over cts (odd ones carried up)."""
    cts = list(cts)
    while len(cts) > 1:
        nxt = [op(cts[i], cts[i + 1]) for i in range(0, len(cts) - 1, 2)]
        if len(cts) % 2:
            nxt.append(cts[-1])
        cts = nxt
    return cts[0]


def eval_add_many(cc, cts) -> Ciphertext:
    return _tree(cc.EvalAdd, cts)


def eval_mult_many(cc, cts) -> Ciphertext:
    return _tree(cc.EvalMult, cts)


def _ladder(cc, ct: Ciphertext, start: int, stop: int) -> Ciphertext:
    """out += rot(out, j) for j = start, 2*start, ... < stop."""
    out = ct
    j = start
    while j < stop:
        out = cc.EvalAdd(out, cc.EvalRotate(out, j))
        j <<= 1
    return out


def eval_sum_keygen(cc, sk, batch_size: int | None = None) -> None:
    batch = batch_size or cc.slots
    cc.EvalRotateKeyGen(sk, [1 << j for j in range(int(math.log2(batch)))])


def eval_sum(cc, ct: Ciphertext, batch_size: int | None = None) -> Ciphertext:
    """Sum over `batch_size` slots into every slot (log2 rotations)."""
    return _ladder(cc, ct, 1, batch_size or ct.slots)


def eval_sum_rows_keygen(cc, sk, row_size: int, batch: int) -> None:
    rots = []
    j = row_size
    while j < batch:
        rots.append(j)
        j <<= 1
    cc.EvalRotateKeyGen(sk, rots)


def eval_sum_rows(cc, ct: Ciphertext, row_size: int,
                  batch: int | None = None) -> Ciphertext:
    """Sum matrix rows (slots viewed as [batch/row_size, row_size])."""
    return _ladder(cc, ct, row_size, batch or ct.slots)


def eval_sum_cols_keygen(cc, sk, row_size: int) -> None:
    cc.EvalRotateKeyGen(sk, [1 << j for j in range(int(math.log2(row_size)))])


def eval_sum_cols(cc, ct: Ciphertext, row_size: int) -> Ciphertext:
    return _ladder(cc, ct, 1, row_size)


def eval_inner_product(cc, ct1: Ciphertext, ct2: Ciphertext,
                       batch_size: int | None = None) -> Ciphertext:
    return eval_sum(cc, cc.EvalMult(ct1, ct2), batch_size)
