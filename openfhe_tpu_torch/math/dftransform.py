"""Discrete Fourier transform over the complex field.

Counterpart of `openfhe_tpu/math/dftransform.py` (reference analog:
dftransform.h, DiscreteFourierTransform: ForwardTransform /
InverseTransform at the odd 2n-th roots of unity, the negacyclic
embedding Field2n uses, and the plain FFT helpers). The JAX package
computes these with numpy's FFT outside any Pallas kernel; here they are
`torch.fft` on complex128 tensors on their own device. The negacyclic
evaluation points are zeta^(2t+1), zeta = exp(i pi / n):
    fwd(c)[t] = sum_k c_k zeta^{k(2t+1)}  =  n * ifft(c * psi)[t],
with psi_k = zeta^k. The two FFT libraries round differently, so the
results agree with the JAX package's to about 1e-15 relative, not bit
for bit.
"""

from __future__ import annotations

import functools
import math

import torch


@functools.lru_cache(maxsize=64)
def _psi(n: int, device: torch.device) -> torch.Tensor:
    angle = torch.arange(n, dtype=torch.float64, device=device) * (
        math.pi / n)
    return torch.polar(torch.ones_like(angle), angle)


def _complex(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(torch.complex128)
    return torch.as_tensor(a, dtype=torch.complex128)


def forward_transform(coeffs) -> torch.Tensor:
    """(reference DiscreteFourierTransform::ForwardTransform) coefficients
    -> values at the n odd 2n-th roots of unity."""
    a = _complex(coeffs)
    n = a.shape[-1]
    return torch.fft.ifft(a * _psi(n, a.device)) * n


def inverse_transform(values) -> torch.Tensor:
    """(reference DiscreteFourierTransform::InverseTransform)"""
    v = _complex(values)
    n = v.shape[-1]
    return torch.fft.fft(v) / n * torch.conj(_psi(n, v.device))


def fft_forward(a) -> torch.Tensor:
    """Plain cyclic DFT (reference FFTForwardTransform)."""
    return torch.fft.fft(_complex(a))


def fft_inverse(a) -> torch.Tensor:
    return torch.fft.ifft(_complex(a))
