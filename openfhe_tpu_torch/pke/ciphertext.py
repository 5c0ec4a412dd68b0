"""Ciphertext and Plaintext types + metadata.

Counterpart of `openfhe_tpu/pke/ciphertext.py` (reference analog:
ciphertext.h, plaintext.h). A ciphertext is a tuple of `[k, N]` int32
EVAL residue tensors (k towers at its level) plus host metadata.
`dataclasses.replace` derives a new one.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Ciphertext:
    elements: tuple                         # tuple of [k, N] int32, EVAL
    level: int = 0
    noise_deg: int = 1
    scale: float = 1.0
    slots: int = 0
    key_tag: str = ""

    @property
    def num_towers(self) -> int:
        return self.elements[0].shape[-2]


@dataclasses.dataclass(frozen=True)
class Plaintext:
    """Encoded plaintext: residues at a level/scale + the host view."""
    poly: torch.Tensor                      # [k, N] int32
    fmt: int = 1                            # EVAL
    level: int = 0
    noise_deg: int = 1
    scale: float = 1.0
    slots: int = 0
    values: Any = None                      # host view (numpy)
    # log2 of the decryption noise seen (reference GetLogError), set by
    # Decrypt under EXEC_NOISE_ESTIMATION
    log_error: float = 0.0

    def GetLogError(self) -> float:
        return self.log_error
