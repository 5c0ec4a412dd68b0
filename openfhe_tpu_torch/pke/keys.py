"""Key types.

Counterpart of `openfhe_tpu/pke/keys.py` (reference analog: publickey.h,
privatekey.h, evalkey.h, keypair.h). Keys are `[k, N]` int32 EVAL residue
tensors plus a `key_tag` naming the secret-key family.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PrivateKey:
    """Secret key s: residues over the extended basis QP (EVAL)."""
    s_qp: torch.Tensor                     # [kQ + kP, N]
    key_tag: str = ""

    def s_q(self, size_ql: int) -> torch.Tensor:
        return self.s_qp[:size_ql]

    def replace(self, **changes) -> "PrivateKey":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class PublicKey:
    """pk = (b, a) with b = -a*s + e over QP (EVAL)."""
    b: torch.Tensor                        # [kQ + kP, N]
    a: torch.Tensor
    key_tag: str = ""

    def replace(self, **changes) -> "PublicKey":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class EvalKey:
    """Hybrid key-switch key: bv/av are [dnum, kQ+kP, N] over QP.

    bv_sh/av_sh are their per-word Shoup companions floor(v * 2^32 / q)
    as int32 bit patterns, for the fused chain's key products
    (`hybrid.shoup_companions`; `keyswitch_gen` and `convert` attach them).
    """
    bv: torch.Tensor
    av: torch.Tensor
    bv_sh: torch.Tensor | None = None
    av_sh: torch.Tensor | None = None
    key_tag: str = ""

    def replace(self, **changes) -> "EvalKey":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class KeyPair:
    public_key: PublicKey
    secret_key: PrivateKey

    @property
    def good(self) -> bool:
        return self.public_key is not None and self.secret_key is not None

    def replace(self, **changes) -> "KeyPair":
        return dataclasses.replace(self, **changes)
