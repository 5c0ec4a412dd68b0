"""Ciphertext and Plaintext types + metadata.

Counterpart of `openfhe_tpu/pke/ciphertext.py` (reference analog:
ciphertext.h, plaintext.h). A ciphertext is a tuple of `[k, N]` int32
EVAL residue tensors (k towers at its level) plus host metadata: the
level, noise degree and scale, the encoding, BGV's integer scaling factor
`scale_int` (reference m_scalingFactorInt) and the metadata map
(reference m_metadataMap), whose entries are carried through every op
untouched. `replace` (a `dataclasses.replace`) derives a new one.
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
    encoding: str = "CKKS_PACKED"
    scale_int: int = 1                      # BGV/BFV bookkeeping
    metadata: tuple = ()                    # ((key, value), ...)

    @property
    def num_towers(self) -> int:
        return self.elements[0].shape[-2]

    @property
    def size(self) -> int:
        return len(self.elements)

    def replace(self, **changes) -> "Ciphertext":
        return dataclasses.replace(self, **changes)

    def with_elements(self, elements) -> "Ciphertext":
        return dataclasses.replace(self, elements=tuple(elements))

    # -- the metadata map (reference CiphertextImpl::*Metadata*) ----------
    def GetMetadataByKey(self, key: str):
        for k, v in self.metadata:
            if k == key:
                return v
        raise KeyError(f"no metadata for key '{key}'")

    def FindMetadataByKey(self, key: str) -> bool:
        return any(k == key for k, _ in self.metadata)

    def SetMetadataByKey(self, key: str, value) -> "Ciphertext":
        """A new ciphertext with the entry set."""
        kept = tuple((k, v) for k, v in self.metadata if k != key)
        return dataclasses.replace(self, metadata=kept + ((key, value),))

    def GetMetadataMap(self) -> dict:
        return dict(self.metadata)

    def Clone(self) -> "Ciphertext":
        return dataclasses.replace(self)

    def CloneZero(self) -> "Ciphertext":
        """The metadata with zero elements (reference CloneZero)."""
        return dataclasses.replace(self, elements=tuple(
            torch.zeros_like(e) for e in self.elements))


@dataclasses.dataclass(frozen=True)
class Plaintext:
    """Encoded plaintext: residues at a level/scale + the host view."""
    poly: torch.Tensor                      # [k, N] int32
    fmt: int = 1                            # EVAL
    level: int = 0
    noise_deg: int = 1
    scale: float = 1.0
    slots: int = 0
    encoding: str = "CKKS_PACKED"
    values: Any = None                      # host view (numpy)
    scale_int: int = 1
    # log2 of the decryption noise seen (reference GetLogError), set by
    # Decrypt under EXEC_NOISE_ESTIMATION
    log_error: float = 0.0

    def replace(self, **changes) -> "Plaintext":
        return dataclasses.replace(self, **changes)

    def GetLogError(self) -> float:
        return self.log_error
