"""Distribution generators on explicit `torch.Generator`s.

Counterpart of `openfhe_tpu/math/sampling.py`, which draws from
`jax.random` keys. Here every draw takes a generator that lives on the
device of the tensors it fills. The two packages give different numbers
from the same seed, so tests check these samplers statistically and feed
JAX-made keys and ciphertexts into the port for word-exact comparisons.

Small signed samples (secrets, errors) are drawn once as int32 `[..., N]`
and lifted to RNS residues across all towers.
"""

from __future__ import annotations

import math

import torch

from openfhe_tpu_torch.lattice.basis import Basis

DEFAULT_SIGMA = 3.19  # reference default (distributiongenerator defaults)


def ternary(gen: torch.Generator, shape,
            hamming_weight: int | None = None) -> torch.Tensor:
    """Uniform ternary {-1, 0, 1} int32 sample (secret keys).

    With `hamming_weight` h, the last axis holds exactly h nonzeros
    (reference: TernaryUniformGeneratorImpl sparse mode)."""
    dev = gen.device
    if hamming_weight is None:
        return torch.randint(-1, 2, tuple(shape), generator=gen, device=dev,
                             dtype=torch.int32)
    n = shape[-1]
    perm = torch.randperm(n, generator=gen, device=dev)
    signs = torch.randint(0, 2, (n,), generator=gen, device=dev,
                          dtype=torch.int32) * 2 - 1
    vals = torch.where(torch.arange(n, device=dev) < hamming_weight, signs,
                       torch.zeros_like(signs))
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    out[perm] = vals
    return out.expand(tuple(shape)).contiguous()


def discrete_gaussian(gen: torch.Generator, shape,
                      sigma: float = DEFAULT_SIGMA,
                      dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Rounded-Gaussian sample, clipped to +-6 sigma (errors). The
    noise-flooding sampler asks for int64: at sigma >= 2^29 the clip
    passes 2^31, where an int32 would wrap."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float64) * sigma
    bound = math.ceil(6.0 * sigma)
    return torch.clamp(torch.round(x), -bound, bound).to(dtype)


def uniform_residues(gen: torch.Generator, basis: Basis,
                     lead_shape=()) -> torch.Tensor:
    """Uniform element of R_Q as independent uniform residues per tower:
    a uniform 62-bit draw reduced mod q_i (bias below 2^-31)."""
    shape = tuple(lead_shape) + (basis.k, basis.ring_dim)
    raw = torch.randint(0, 1 << 62, shape, generator=gen, device=gen.device,
                        dtype=torch.int64)
    return torch.remainder(raw, basis.q.long()).int()


def to_residues(small: torch.Tensor, basis: Basis) -> torch.Tensor:
    """Lift signed int32 or int64 [..., N] to [..., k, N] residues.
    `torch.remainder` takes the sign of the divisor, so results are in
    [0, q) (not `fmod`)."""
    return torch.remainder(small[..., None, :].long(), basis.q.long()).int()
