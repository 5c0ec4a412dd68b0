"""Frozen work counts: the least bytes and 32-bit operations of each
operation a request runs, from its shapes alone.

They count the operation, not the kernels that happen to run it, so a
change that fuses, splits or removes kernels leaves them as they are.
Bytes: each input, key and output word read or written once, 4 bytes a
word; twiddles and other tables are not counted. Operations, at the port's
own per-step counts (`chip_smoke.py`): a butterfly 10 (a Shoup product 5,
an add 2, a subtract 3), a Shoup product 5, a 64-bit product reduced 10, a
term of a lazy base conversion 5 and its one final reduction 11, a key
product's term 7, a blind rotation's 64-bit product term 4. A transform's
N^-1 and a conversion's (D/d_i)^-1 share one Shoup product a word. HYBRID
key switching counts what the level's digits need: each digit's own
towers extended to the rest of Q_L P, one key product a digit, one
mod-down a ciphertext element. GINX counts its n steps as its step loop runs them.
"""

from __future__ import annotations

import math

WORD = 4
BUTTERFLY = 10
SHOUP = 5
ADD = 2
SUB = 3
MULMOD = 10
LAZY_TERM = 5
REDUCE_WIDE = 11
KEY_TERM = 7
MATMUL_TERM = 4
CENTRE = 3
DIGIT = 6


def ntt(rows: int, n: int) -> int:
    return rows * (n // 2) * (n.bit_length() - 1) * BUTTERFLY


def intt(rows: int, n: int) -> int:
    return ntt(rows, n) + rows * n * SHOUP


def conversion(outputs: int, terms: int) -> int:
    return outputs * (terms * LAZY_TERM + REDUCE_WIDE)


def digit_sizes(size: int, alpha: int, digits: int) -> list:
    count = min(-(-size // alpha), digits)
    return [min(alpha, size - j * alpha) for j in range(count)]


def mod_up(n: int, size: int, kp: int, alpha: int, digits: int) -> int:
    sizes = digit_sizes(size, alpha, digits)
    return intt(size, n) + sum(conversion(n * (size + kp - a), a)
                               + ntt(size + kp - a, n) for a in sizes)


def key_inner(n: int, size: int, kp: int, nd: int) -> int:
    return 2 * nd * (size + kp) * n * KEY_TERM


def mod_down(n: int, size: int, kp: int) -> int:
    """One element: its P part to coefficients, converted to Q_L, back to
    EVAL, subtracted and multiplied by P^-1."""
    return (intt(kp, n) + conversion(n * size, kp) + ntt(size, n)
            + size * n * (SUB + SHOUP))


# -- CKKS operations: (bytes, operations) at a level of `size` Q towers ----

def eval_mult(n, size, kp, alpha, digits):
    """EvalMult of two ciphertexts, relinearized (Karatsuba's three
    products and four adds a word)."""
    nd = len(digit_sizes(size, alpha, digits))
    ops = (size * n * (3 * MULMOD + 2 * ADD + 2 * SUB)
           + mod_up(n, size, kp, alpha, digits) + key_inner(n, size, kp, nd)
           + 2 * mod_down(n, size, kp) + 2 * size * n * ADD)
    words = n * (4 * size + 2 * nd * (size + kp) + 2 * size)
    return WORD * words, ops


def rescale(n, size):
    """Rescale of two elements by their last tower."""
    rest = size - 1
    ops = 2 * (intt(1, n) + rest * n * (ADD + SUB) + ntt(rest, n)
               + rest * n * (SUB + SHOUP))
    return WORD * n * (2 * size + 2 * rest), ops


def fast_rotation_precompute(n, size, kp, alpha, digits):
    nd = len(digit_sizes(size, alpha, digits))
    return (WORD * n * (size + nd * (size + kp)),
            mod_up(n, size, kp, alpha, digits))


def fast_rotation(n, size, kp, alpha, digits):
    """A rotation on hoisted digits: their permutation, the key product,
    two mod-downs and the rotated c0 added."""
    nd = len(digit_sizes(size, alpha, digits))
    ops = (key_inner(n, size, kp, nd) + 2 * mod_down(n, size, kp)
           + size * n * ADD)
    words = n * (nd * (size + kp) + 2 * nd * (size + kp) + size + 2 * size)
    return WORD * words, ops


def mult_plain(n, size):
    return WORD * n * 5 * size, 2 * size * n * MULMOD


def add(n, size):
    return WORD * n * 6 * size, 2 * size * n * ADD


# -- GINX gates -------------------------------------------------------------

def gate_batch(batch, n_lwe, ring, q_bits, base_g, q_ks, base_ks):
    """EvalBinGate over `batch` gates: the LWE add, the test vector and its
    transform, n GINX steps (two inverse and d2 forward transforms, the
    signed digits, the two CMUX keys' products and monomials), the
    extraction, the switches to q_KS, the key switch and the switch to q.
    Bytes: the bootstrapping key once a batch, the switching key's rows a
    gate selects (at least one per coordinate and digit), the inputs and
    outputs once."""
    digits_g = math.ceil(q_bits / math.log2(base_g))
    d2 = 2 * (digits_g - 1)
    d_ks = math.ceil(math.log2(q_ks) / math.log2(base_ks))
    log_n = ring.bit_length() - 1
    step = ((2 + d2) * ring // 2 * log_n * BUTTERFLY + 2 * ring * SHOUP
            + 2 * ring * (CENTRE + digits_g * DIGIT)
            + ring * (4 * d2 * MATMUL_TERM + 6 * MULMOD + 4 * MATMUL_TERM))
    per_gate = ((n_lwe + 1) * ADD + ring * ADD + ntt(1, ring)
                + n_lwe * step + intt(2, ring) + (ring + 1) * 4
                + ring * d_ks * (DIGIT + (n_lwe + 1) * ADD)
                + (n_lwe + 1) * 4)
    words = (n_lwe * 2 * d2 * 2 * ring + ring * d_ks * (n_lwe + 1)
             + batch * 3 * (n_lwe + 1))
    return WORD * words, batch * per_gate
