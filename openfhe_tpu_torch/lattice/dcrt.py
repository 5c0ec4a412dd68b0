"""DCRT (RNS) polynomial: a residue tensor `[..., k, N]` + its format.

Counterpart of the `Poly` of `openfhe_tpu/lattice/dcrt.py` (reference
analog: DCRTPolyImpl). COEFF = natural-order coefficients; EVAL =
negacyclic NTT values in bit-reversed order.
"""

from __future__ import annotations

import dataclasses

import torch

COEFF = 0
EVAL = 1


@dataclasses.dataclass(frozen=True)
class Poly:
    """A DCRT ring element: residues `data[..., k, N]` + format flag."""
    data: torch.Tensor
    fmt: int = EVAL

    @property
    def k(self) -> int:
        return self.data.shape[-2]
