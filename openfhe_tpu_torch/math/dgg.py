"""Discrete Gaussian sampling over the integers with arbitrary center/sigma.

Counterpart of `openfhe_tpu/math/dgg.py` (reference analog:
discretegaussiangenerator{,-impl}.h, the Peikert-inversion table sampler
and GenerateIntegerKarney). The same two methods, on a tensor of centers
on its device, with the variates from a draw source (`math/draws.py`):
  * sigma <= _TABLE_SIGMA: exact inversion sampling from the full CDF
    table over center +/- 12 sigma (float64, [n, L] with
    L = 2 * ceil(12 sigma) + 3), one uniform a center;
  * larger sigma: the rounded continuous Gaussian, one standard normal a
    center (statistically within ~2^-128 of the discrete Gaussian once
    sigma exceeds the smoothing parameter, as the JAX package argues).
On the same variates both give the JAX package's integers. The table is
built in chunks of rows so that a million centers at sigma 40 stay
within a few hundred MB of device memory; the uniforms are drawn at once
for all centers first, as the JAX package draws them.
"""

from __future__ import annotations

import math

import torch

from openfhe_tpu_torch.math.draws import TorchDraws, torch_draws

KARNEY_THRESHOLD = 300.0        # reference discretegaussiangenerator.h:79
_TABLE_SIGMA = 64.0
_TAIL = 12.0
_TABLE_WORDS = 1 << 24          # float64 table entries a chunk


def _table_sample(centers: torch.Tensor, sigma: float,
                  draws) -> torch.Tensor:
    """Exact inversion sampling over a flat float64 tensor of centers."""
    base = torch.floor(centers)
    frac = centers - base                      # in [0, 1)
    w = int(math.ceil(_TAIL * sigma)) + 1
    offs = torch.arange(-w, w + 1, dtype=torch.float64,
                        device=centers.device)
    u_raw = draws.random(centers.numel())
    out = torch.empty(centers.numel(), dtype=torch.int64,
                      device=centers.device)
    step = max(1, _TABLE_WORDS // offs.numel())
    for lo in range(0, centers.numel(), step):
        hi = min(lo + step, centers.numel())
        # weights exp(-(x - c)^2 / (2 sigma^2)) at x = base + offs
        d = offs[None, :] - frac[lo:hi, None]
        logw = -(d * d) / (2.0 * sigma * sigma)
        wgt = torch.exp(logw - logw.max(dim=1, keepdim=True).values)
        cdf = torch.cumsum(wgt, dim=1)
        u = u_raw[lo:hi] * cdf[:, -1]
        # the count of CDF entries below u: the first entry >= u
        idx = torch.searchsorted(cdf, u[:, None]).squeeze(1)
        out[lo:hi] = (base[lo:hi] + offs[idx]).long()
    return out


def sample_integers(centers, sigma: float, draws) -> torch.Tensor:
    """D_{Z, sigma, c} for a tensor of centers: int64 of their shape (at
    least one dimension), on their device (see the module docstring)."""
    centers = torch.atleast_1d(torch.as_tensor(centers, dtype=torch.float64,
                                               device=draws.device))
    if sigma <= 0:
        return torch.round(centers).long()
    if sigma <= _TABLE_SIGMA:
        flat = centers.reshape(-1)
        return _table_sample(flat, sigma, draws).reshape(centers.shape)
    z = draws.normal(tuple(centers.shape))
    return torch.round(centers + sigma * z).long()


class DiscreteGaussianGenerator:
    """(reference DiscreteGaussianGeneratorImpl) drawing from
    `generator`, on its device, through `self.draws`; without one, from a
    fresh generator on `device` (the GPU when None; raises when there is
    none)."""

    def __init__(self, sigma: float = 3.19, device=None,
                 generator: torch.Generator | None = None):
        self.sigma = float(sigma)
        self.draws = (torch_draws(device) if generator is None
                      else TorchDraws(generator))
        self.device = self.draws.device

    def GenerateInteger(self, center: float = 0.0,
                        sigma: float | None = None) -> int:
        s = self.sigma if sigma is None else sigma
        return int(sample_integers([center], s, self.draws)[0])

    def GenerateIntegerKarney(self, mean: float, stddev: float) -> int:
        """(reference GenerateIntegerKarney) arbitrary-parameter sampling;
        see the module docstring for the method."""
        return int(sample_integers([mean], stddev, self.draws)[0])

    def GenerateIntVector(self, size: int) -> torch.Tensor:
        return sample_integers(torch.zeros(size, dtype=torch.float64,
                                           device=self.device),
                               self.sigma, self.draws)

    def GenerateVector(self, size: int, centers=None,
                       sigma: float | None = None) -> torch.Tensor:
        c = (torch.zeros(size, dtype=torch.float64, device=self.device)
             if centers is None else centers)
        return sample_integers(c, self.sigma if sigma is None else sigma,
                               self.draws)
