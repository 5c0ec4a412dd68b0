"""Single-modulus negacyclic ring Z_q[x]/(x^n + 1) for the lattice toolbox.

Counterpart of `openfhe_tpu/lattice/ringq.py` (reference analog:
NativePoly as the trapdoor / GPV machinery uses it). A `RingPoly` is an
`[n]` int32 tensor of words in [0, q) on its ring's device, over the
one-tower `Basis` of `lattice/basis.make_basis([q], n)`. `SetFormat`
runs the port's NTT (`ops/ntt.ntt_fwd` / `ntt_inv`): kernel m
(`csrc/ntt_small.cu`) for 128 <= n <= 2048 and kernels a/b
(`csrc/ntt.cu`) for the other rings on the card, their plain twins on
the CPU. The JAX package's host NTT (`pke/encoding/packed._host_ntt`)
takes the same root, `root_of_unity(2n, q)`, in the same bit-reversed
order as the basis' tables, so EVALUATION words carry over unchanged.
The rest is exact int64 arithmetic on the tensors.

Limit: the port's words are 31-bit (`pke/parameters.MAX_MODULUS_BITS`),
so `RingParams` refuses q >= 2^31, where the JAX package takes q < 2^32.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from openfhe_tpu_torch._device import resolve_device
from openfhe_tpu_torch.lattice.basis import Basis, make_basis
from openfhe_tpu_torch.math import nbtheory
from openfhe_tpu_torch.ops import ntt
from openfhe_tpu_torch.pke.parameters import MAX_MODULUS_BITS

COEFFICIENT = "COEFFICIENT"
EVALUATION = "EVALUATION"


@functools.lru_cache(maxsize=32)
def _ring(n: int, q: int, device: torch.device) -> "RingParams":
    return RingParams(n, q, make_basis([q], n, device=device))


@dataclasses.dataclass(frozen=True)
class RingParams:
    n: int
    q: int
    basis: Basis = dataclasses.field(compare=False, repr=False)

    @property
    def device(self) -> torch.device:
        return self.basis.device

    @staticmethod
    def create(n: int, n_bits: int = 0, q: int = 0,
               device=None) -> "RingParams":
        """Pick an NTT-friendly prime (q = 1 mod 2n) when not given. On
        `device`: the GPU when None (raising when there is none)."""
        if q == 0:
            q = nbtheory.first_prime(n_bits or 30, 2 * n)
        if q >= 1 << MAX_MODULUS_BITS:
            raise ValueError(f"q = {q} has more than {MAX_MODULUS_BITS} "
                             "bits: the port's words are 31-bit")
        return _ring(n, int(q), resolve_device(device))


class RingPoly:
    __slots__ = ("params", "data", "fmt")

    def __init__(self, params: RingParams, data=None,
                 fmt: str = EVALUATION):
        """`data`: n integers (a tensor, or anything numpy reads), taken
        mod q; zeros when None."""
        dev = params.device
        if data is None:
            self.data = torch.zeros(params.n, dtype=torch.int32, device=dev)
        else:
            if not isinstance(data, torch.Tensor):
                data = torch.as_tensor(np.asarray(data, np.int64))
            self.data = torch.remainder(data.to(dev, torch.int64),
                                        params.q).int()
        self.params = params
        self.fmt = fmt

    @classmethod
    def _words(cls, params, words: torch.Tensor, fmt: str) -> "RingPoly":
        """Wrap int32 or int64 words already in [0, q)."""
        out = cls.__new__(cls)
        out.params, out.data, out.fmt = params, words.int(), fmt
        return out

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_coeffs(cls, params, coeffs) -> "RingPoly":
        return cls(params, coeffs, COEFFICIENT)

    @classmethod
    def constant(cls, params, value: int,
                 fmt: str = EVALUATION) -> "RingPoly":
        if fmt == EVALUATION:
            return cls(params, torch.full((params.n,), value % params.q,
                                          dtype=torch.int64), EVALUATION)
        c = torch.zeros(params.n, dtype=torch.int64)
        c[0] = value % params.q
        return cls(params, c, COEFFICIENT)

    @classmethod
    def uniform(cls, params, draws) -> "RingPoly":
        return cls(params, draws.integers(0, params.q, params.n), EVALUATION)

    # -- format ------------------------------------------------------------
    def SetFormat(self, fmt: str) -> "RingPoly":
        if fmt == self.fmt:
            return self
        basis = self.params.basis
        x = self.data.view(1, self.params.n)
        out = (ntt.ntt_inv(x, basis) if fmt == COEFFICIENT
               else ntt.ntt_fwd(x, basis))
        return RingPoly._words(self.params, out.view(self.params.n), fmt)

    # -- arithmetic (mod q) ------------------------------------------------
    def _bin(self, other, op) -> "RingPoly":
        q = self.params.q
        if isinstance(other, RingPoly):
            if self.fmt != other.fmt:
                raise ValueError(f"format mismatch: {self.fmt} and "
                                 f"{other.fmt}")
            return RingPoly._words(self.params, op(
                self.data.long(), other.data.long(), q), self.fmt)
        v = int(other) % q
        a = self.data.long()
        if self.fmt == EVALUATION:
            return RingPoly._words(self.params, op(a, v, q), self.fmt)
        out = a.clone()
        out[:1] = op(a[:1], v, q)
        return RingPoly._words(self.params, out, self.fmt)

    def __add__(self, other):
        return self._bin(other, lambda a, b, q: (a + b) % q)

    def __sub__(self, other):
        return self._bin(other, lambda a, b, q: (a + q - b) % q)

    def __mul__(self, other):
        q = self.params.q
        if isinstance(other, RingPoly):
            if self.fmt != EVALUATION or other.fmt != EVALUATION:
                raise ValueError("ring multiply requires EVALUATION format")
            return RingPoly._words(self.params, self.data.long()
                                   * other.data.long() % q, EVALUATION)
        v = int(other) % q
        return RingPoly._words(self.params, self.data.long() * v % q,
                               self.fmt)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        q = self.params.q
        return RingPoly._words(self.params, (q - self.data.long()) % q,
                               self.fmt)

    def __eq__(self, other):
        return (isinstance(other, RingPoly) and self.fmt == other.fmt
                and self.params == other.params
                and bool(torch.equal(self.data, other.data)))

    def Transpose(self) -> "RingPoly":
        """a(x) -> a(x^-1) = a(x^(2n-1)) (reference Poly::Transpose)."""
        q = self.params.q
        c = self.SetFormat(COEFFICIENT).data.long()
        out = torch.empty_like(c)
        out[0] = c[0]
        out[1:] = (q - torch.flip(c[1:], (0,))) % q
        return RingPoly._words(self.params, out,
                               COEFFICIENT).SetFormat(self.fmt)

    # -- views -------------------------------------------------------------
    def centered(self) -> torch.Tensor:
        """Coefficients lifted to (-q/2, q/2] as int64."""
        c = self.SetFormat(COEFFICIENT).data.long()
        q = self.params.q
        return torch.where(c > q // 2, c - q, c)

    def Norm(self) -> float:
        return float(self.centered().abs().max())
