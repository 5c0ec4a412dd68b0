"""Carry keys and ciphertexts between the JAX package and the port.

The JAX package's objects are handed over as numpy uint32 arrays
(`np.asarray(jax_array)`); these functions build the port's objects on a
chosen device, and `to_numpy` turns the port's int32 tensors back into
uint32 words. Keys and encryptions are random and the two packages' RNGs
never agree, so word-exact comparisons feed JAX-made keys and ciphertexts
into the port through this module.
"""

from __future__ import annotations

import numpy as np

from openfhe_tpu_torch.math.modops import to_u32, u32_tensor
from openfhe_tpu_torch.pke.ciphertext import Ciphertext
from openfhe_tpu_torch.pke.keys import EvalKey, PrivateKey, PublicKey


def private_key_from_numpy(s_qp, key_tag: str = "",
                           device="cpu") -> PrivateKey:
    """s_qp: [kQ+kP, N] uint32 EVAL words."""
    return PrivateKey(s_qp=u32_tensor(s_qp, device), key_tag=key_tag)


def public_key_from_numpy(b, a, key_tag: str = "", device="cpu") -> PublicKey:
    return PublicKey(b=u32_tensor(b, device), a=u32_tensor(a, device),
                     key_tag=key_tag)


def eval_key_from_numpy(bv, av, key_tag: str = "", device="cpu") -> EvalKey:
    """bv, av: [nd, kQ+kP, N] uint32 words of a hybrid key-switch key."""
    return EvalKey(bv=u32_tensor(bv, device), av=u32_tensor(av, device),
                   key_tag=key_tag)


def ciphertext_from_numpy(elements, level: int = 0, noise_deg: int = 1,
                          scale: float = 1.0, slots: int = 0,
                          key_tag: str = "", device="cpu") -> Ciphertext:
    """elements: a sequence of [k, N] uint32 EVAL words."""
    return Ciphertext(elements=tuple(u32_tensor(e, device)
                                     for e in elements),
                      level=level, noise_deg=noise_deg, scale=scale,
                      slots=slots, key_tag=key_tag)


def to_numpy(x) -> np.ndarray:
    """A port tensor (int32 bits) -> numpy uint32 words."""
    return to_u32(x)
