"""Field2n: elements of the 2n-th cyclotomic number field Q[x]/(x^n + 1).

Counterpart of `openfhe_tpu/lattice/field2n.py` (reference analog:
field2n{,-impl}.h, the complex-vector field elements of GPV perturbation
sampling). An element is a complex128 tensor of n values on its device.

Format semantics match the reference: COEFFICIENT holds the n rational
coefficients; EVALUATION holds values at the odd 2n-th roots of unity
zeta^(2t+1), zeta = exp(i pi / n), t = 0..n-1 (`math/dftransform.py`:
eval = n * ifft(coeff * psi), psi_k = zeta^k). Every op returns a new
Field2n, as the JAX package's do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openfhe_tpu_torch._device import resolve_device

COEFFICIENT = "COEFFICIENT"
EVALUATION = "EVALUATION"


class Field2n:
    __slots__ = ("data", "fmt")

    def __init__(self, data, fmt: str = COEFFICIENT, device=None):
        """`data`: a tensor (kept on its device unless `device` is given)
        or anything numpy reads (put on `device`: the GPU when None,
        raising when there is none)."""
        if isinstance(data, torch.Tensor):
            dev = data.device if device is None else torch.device(device)
            self.data = data.to(device=dev, dtype=torch.complex128)
        else:
            self.data = torch.as_tensor(np.asarray(data),
                                        dtype=torch.complex128,
                                        device=resolve_device(device))
        self.fmt = fmt

    # -- constructors ------------------------------------------------------
    @classmethod
    def zeros(cls, n: int, fmt: str = EVALUATION,
              device=None) -> "Field2n":
        return cls(torch.zeros(n, dtype=torch.complex128,
                               device=resolve_device(device)), fmt)

    @classmethod
    def from_int_vector(cls, vec: torch.Tensor) -> "Field2n":
        """(reference Field2n(const Matrix<int64_t>&)) an integer tensor's
        values as coefficients, on its device."""
        return cls(vec.to(torch.float64), COEFFICIENT)

    @property
    def device(self) -> torch.device:
        return self.data.device

    # -- basics ------------------------------------------------------------
    def size(self) -> int:
        return self.data.shape[0]

    def __getitem__(self, i):
        return self.data[i]

    def __len__(self):
        return self.data.shape[0]

    def Norm(self) -> float:
        return float(self.data.abs().max())

    # -- format ------------------------------------------------------------
    def SwitchFormat(self) -> "Field2n":
        from openfhe_tpu_torch.math import dftransform as dft
        if self.fmt == COEFFICIENT:
            return Field2n(dft.forward_transform(self.data), EVALUATION)
        return Field2n(dft.inverse_transform(self.data), COEFFICIENT)

    def SetFormat(self, fmt: str) -> "Field2n":
        return self if fmt == self.fmt else self.SwitchFormat()

    # -- arithmetic --------------------------------------------------------
    def Plus(self, rhs) -> "Field2n":
        if isinstance(rhs, Field2n):
            _same_format(self, rhs)
            return Field2n(self.data + rhs.data, self.fmt)
        out = self.data.clone()
        if self.fmt == COEFFICIENT:
            out[0] += rhs
        else:
            out += rhs          # adding a scalar constant in eval domain
        return Field2n(out, self.fmt)

    def Minus(self, rhs) -> "Field2n":
        if isinstance(rhs, Field2n):
            _same_format(self, rhs)
            return Field2n(self.data - rhs.data, self.fmt)
        return self.Plus(-rhs)

    def Times(self, rhs) -> "Field2n":
        if isinstance(rhs, Field2n):
            if self.fmt != EVALUATION or rhs.fmt != EVALUATION:
                raise ValueError("Times requires EVALUATION format")
            return Field2n(self.data * rhs.data, self.fmt)
        return Field2n(self.data * rhs, self.fmt)

    def ScalarMult(self, d: float) -> "Field2n":
        return Field2n(self.data * d, self.fmt)

    def Inverse(self) -> "Field2n":
        _need(self, EVALUATION, "Inverse")
        return Field2n(torch.conj(self.data) / self.data.abs() ** 2,
                       self.fmt)

    def ShiftRight(self) -> "Field2n":
        """Multiply by x (reference field2n-impl.h ShiftRight)."""
        _need(self, COEFFICIENT, "ShiftRight")
        out = torch.roll(self.data, 1)
        out[0] = -out[0]
        return Field2n(out, COEFFICIENT)

    def __add__(self, rhs):
        return self.Plus(rhs)

    def __radd__(self, rhs):
        return self.Plus(rhs)

    def __sub__(self, rhs):
        return self.Minus(rhs)

    def __mul__(self, rhs):
        return self.Times(rhs)

    def __rmul__(self, rhs):
        return self.Times(rhs)

    def __neg__(self):
        return Field2n(-self.data, self.fmt)

    def __eq__(self, rhs):
        return (isinstance(rhs, Field2n) and self.fmt == rhs.fmt
                and self.data.shape == rhs.data.shape
                and bool(torch.allclose(self.data, rhs.data.to(
                    self.device))))

    # -- automorphisms / structure ----------------------------------------
    def AutomorphismTransform(self, i: int) -> "Field2n":
        """x -> x^i on evaluation slots (i odd)."""
        _need(self, EVALUATION, "AutomorphismTransform")
        if i % 2 != 1:
            raise ValueError("automorphism index must be odd")
        dest = _automorphism_dest(self.size(), i, self.device)
        out = torch.empty_like(self.data)
        out[dest] = self.data
        return Field2n(out, EVALUATION)

    def Transpose(self) -> "Field2n":
        """Conjugate-transpose element t(x) = a(x^-1) (reference
        field2n-impl.h Transpose)."""
        if self.fmt == EVALUATION:
            return self.AutomorphismTransform(2 * self.size() - 1)
        out = torch.empty_like(self.data)
        out[0] = self.data[0]
        out[1:] = -torch.flip(self.data[1:], (0,))
        return Field2n(out, COEFFICIENT)

    def ExtractEven(self) -> "Field2n":
        _need(self, COEFFICIENT, "ExtractEven")
        return Field2n(self.data[0::2].contiguous(), COEFFICIENT)

    def ExtractOdd(self) -> "Field2n":
        _need(self, COEFFICIENT, "ExtractOdd")
        return Field2n(self.data[1::2].contiguous(), COEFFICIENT)

    def Permute(self) -> "Field2n":
        """Interleaved -> [evens | odds] (reference Permute)."""
        _need(self, COEFFICIENT, "Permute")
        return Field2n(torch.cat([self.data[0::2], self.data[1::2]]),
                       COEFFICIENT)

    def InversePermute(self) -> "Field2n":
        _need(self, COEFFICIENT, "InversePermute")
        return Field2n(interleave(self.data), COEFFICIENT)


def interleave(halves: torch.Tensor) -> torch.Tensor:
    """[evens | odds] -> interleaved (the inverse of Permute), for any
    dtype."""
    n = halves.shape[0]
    return halves.view(2, n // 2).t().reshape(n)


def _same_format(a: Field2n, b: Field2n) -> None:
    if a.fmt != b.fmt:
        raise ValueError(f"format mismatch: {a.fmt} and {b.fmt}")


def _need(x: Field2n, fmt: str, op: str) -> None:
    if x.fmt != fmt:
        raise ValueError(f"{op} needs {fmt} format, not {x.fmt}")


@functools.lru_cache(maxsize=64)
def _automorphism_dest(n: int, i: int, device: torch.device) -> torch.Tensor:
    """Slot t goes to slot ((2t+1) i mod 2n - 1) / 2."""
    t = np.arange(n, dtype=np.int64)
    idx = ((2 * t + 1) * i) % (2 * n)
    return torch.as_tensor((idx - 1) // 2, device=device)
