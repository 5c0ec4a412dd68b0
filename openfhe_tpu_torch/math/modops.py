"""Modular arithmetic on residue tensors.

Counterpart of `openfhe_tpu/math/modops.py`. Residues are canonical
values in [0, q) for odd primes q < 2^31, stored as `torch.int32`, so
their bits equal the JAX package's uint32 words. The tensor functions
widen to int64, where every product of two residues (< 2^62) is exact,
and return int32.

Shoup companions floor(c * 2^32 / q) use all 32 bits. They are stored as
int32 bit patterns: CUDA kernels read them as `uint32_t`, plain torch
reads them with `u32()`.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# host-side helpers (Python ints; exact)
# ---------------------------------------------------------------------------

def shoup(c: int, q: int) -> int:
    """Shoup companion floor(c * 2^32 / q) for constant-multiplier modmul."""
    if not 0 <= c < q:
        raise ValueError(f"shoup constant {c} out of range for q={q}")
    return (c << 32) // q


def mod_constants(q: int) -> tuple[int, int, int]:
    """(r32, r32_shoup, m32): r32 = 2^32 mod q, m32 = floor(2^32 / q)."""
    r32 = (1 << 32) % q
    return r32, shoup(r32, q), (1 << 32) // q


def u32_tensor(words, device="cpu") -> torch.Tensor:
    """numpy words (any integer dtype, values < 2^32) -> int32 bit
    patterns on `device`."""
    arr = np.ascontiguousarray(np.asarray(words).astype(np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32 words (the JAX package's layout)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def shoup_pair(vals, mods, device="cpu"):
    """(c, c_shoup) int32 columns [k, 1] for per-tower constants."""
    c = np.array([int(v) for v in vals], np.uint64)
    q = np.array([int(m) for m in mods], np.uint64)
    sh = (c << np.uint64(32)) // q
    return (u32_tensor(c.reshape(-1, 1), device),
            u32_tensor(sh.reshape(-1, 1), device))


# ---------------------------------------------------------------------------
# tensor primitives
# ---------------------------------------------------------------------------

def u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values as int64."""
    return t.long() & _MASK32


def i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).int()


def _wide(q):
    return q.long() if isinstance(q, torch.Tensor) else int(q)


def add_mod(a, b, q):
    """(a + b) mod q for canonical residues (b may be a Python int)."""
    q = _wide(q)
    t = a.long() + _wide(b)
    return torch.where(t >= q, t - q, t).int()


def sub_mod(a, b, q):
    """(a - b) mod q for canonical residues (b may be a Python int)."""
    q = _wide(q)
    t = a.long() - _wide(b)
    return torch.where(t < 0, t + q, t).int()


def neg_mod(a, q):
    """(-a) mod q for canonical residues."""
    a = a.long()
    return torch.where(a == 0, a, _wide(q) - a).int()


def mul_mod(a, b, q):
    """a * b mod q for residues a, b < 2^31 (exact int64 product)."""
    return torch.remainder(a.long() * b.long(), _wide(q)).int()


def mul_mod_shoup(x, c, c_sh, q):
    """x * c mod q with c_sh = floor(c * 2^32 / q) (Shoup), for x < 2^31.

    The quotient estimate floor(x * c_sh / 2^32) is at most one short, so
    one conditional subtract makes the result canonical (reference:
    `ModMulFastConst`, ubintnat.h)."""
    q = _wide(q)
    x = x.long()
    qhat = (x * u32(c_sh)) >> 32
    t = x * c.long() - qhat * q
    return torch.where(t >= q, t - q, t).int()
