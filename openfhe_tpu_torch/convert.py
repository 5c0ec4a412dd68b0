"""Carry keys and ciphertexts between the JAX package and the port.

The JAX package's objects are handed over as numpy uint32 arrays
(`np.asarray(jax_array)`); these functions build the port's objects on a
device, `cuda` unless another is named (they raise when there is no GPU,
as the context does), and `to_numpy` turns the port's int32 tensors back
into uint32 words. Keys and encryptions are random and the two packages'
RNGs never agree, so word-exact comparisons feed JAX-made keys and
ciphertexts into the port through this module: CKKS, BGV and BFV
ciphertexts with their metadata (`ciphertext_from_numpy`), plaintexts
(`plaintext_from_numpy`), hybrid and BV key-switch keys. The `lwe_*`,
`switching_key_*` and `bt_key_*` functions carry BinFHE state.
"""

from __future__ import annotations

import numpy as np

from openfhe_tpu_torch._device import resolve_device
from openfhe_tpu_torch.binfhe import lwe
from openfhe_tpu_torch.binfhe.constants import BINFHE_METHOD
from openfhe_tpu_torch.math.modops import to_u32, u32_tensor
from openfhe_tpu_torch.pke.ciphertext import Ciphertext, Plaintext
from openfhe_tpu_torch.pke.keys import EvalKey, PrivateKey, PublicKey
from openfhe_tpu_torch.pke.keyswitch.hybrid import shoup_companions


def private_key_from_numpy(s_qp, key_tag: str = "",
                           device=None) -> PrivateKey:
    """s_qp: [kQ+kP, N] uint32 EVAL words."""
    return PrivateKey(s_qp=u32_tensor(s_qp, resolve_device(device)),
                      key_tag=key_tag)


def public_key_from_numpy(b, a, key_tag: str = "", device=None) -> PublicKey:
    dev = resolve_device(device)
    return PublicKey(b=u32_tensor(b, dev), a=u32_tensor(a, dev),
                     key_tag=key_tag)


def eval_key_from_numpy(bv, av, key_tag: str = "", device=None, bv_sh=None,
                        av_sh=None, moduli_qp=None) -> EvalKey:
    """bv, av: [nd, kQ+kP, N] uint32 words of a hybrid key-switch key;
    bv_sh, av_sh: their Shoup companions, computed from the QP moduli
    `moduli_qp` when not given."""
    dev = resolve_device(device)
    ek = EvalKey(bv=u32_tensor(bv, dev), av=u32_tensor(av, dev),
                 key_tag=key_tag)
    if bv_sh is not None and av_sh is not None:
        return EvalKey(bv=ek.bv, av=ek.av, bv_sh=u32_tensor(bv_sh, dev),
                       av_sh=u32_tensor(av_sh, dev), key_tag=key_tag)
    if moduli_qp is None:
        raise ValueError("eval_key_from_numpy: give bv_sh and av_sh, or "
                         "moduli_qp to compute them")
    return shoup_companions(ek, moduli_qp)


def bv_key_from_numpy(bv, av, key_tag: str = "", device=None, bv_sh=None,
                      av_sh=None) -> EvalKey:
    """A BV key-switch key in `bv.keyswitch_gen`'s layout: bv, av
    [rows, kQ, N] uint32 words, a row per tower (digit_size 0) or per
    (tower, digit) pair. BV's key product needs no Shoup companions; they
    are kept where given (digit_size 0 keys have them)."""
    dev = resolve_device(device)
    sh = [None if v is None else u32_tensor(v, dev) for v in (bv_sh, av_sh)]
    return EvalKey(bv=u32_tensor(bv, dev), av=u32_tensor(av, dev),
                   bv_sh=sh[0], av_sh=sh[1], key_tag=key_tag)


def eval_key_map_from_numpy(key_map, key_tag: str | None = None,
                            device=None, moduli_qp=None) -> dict:
    """An automorphism key map {g: key} -> {g: EvalKey} on a device. Each
    key has `bv`, `av` and, where present, `bv_sh`, `av_sh` as arrays numpy
    can read (the fields of the JAX package's EvalKey); `key_tag` defaults
    to each key's own."""
    out = {}
    for g, k in key_map.items():
        sh = [getattr(k, name, None) for name in ("bv_sh", "av_sh")]
        sh = [None if v is None else np.asarray(v) for v in sh]
        out[int(g)] = eval_key_from_numpy(
            np.asarray(k.bv), np.asarray(k.av),
            key_tag=k.key_tag if key_tag is None else key_tag, device=device,
            bv_sh=sh[0], av_sh=sh[1], moduli_qp=moduli_qp)
    return out


def ciphertext_from_numpy(elements, level: int = 0, noise_deg: int = 1,
                          scale: float = 1.0, slots: int = 0,
                          key_tag: str = "", device=None,
                          encoding: str = "CKKS_PACKED", scale_int: int = 1,
                          metadata=()) -> Ciphertext:
    """elements: a sequence of [k, N] uint32 EVAL words; the rest is the
    JAX ciphertext's metadata (BGV's `scale_int`, the metadata map's
    (key, value) pairs)."""
    dev = resolve_device(device)
    return Ciphertext(elements=tuple(u32_tensor(e, dev) for e in elements),
                      level=level, noise_deg=noise_deg, scale=scale,
                      slots=slots, key_tag=key_tag, encoding=encoding,
                      scale_int=int(scale_int), metadata=tuple(metadata))


def ciphertext_from_jax(ct, device=None) -> Ciphertext:
    """A JAX package Ciphertext (anything with its fields) on a device."""
    return ciphertext_from_numpy(
        [np.asarray(e) for e in ct.elements], level=ct.level,
        noise_deg=ct.noise_deg, scale=ct.scale, slots=ct.slots,
        key_tag=ct.key_tag, device=device, encoding=ct.encoding,
        scale_int=ct.scale_int, metadata=ct.metadata)


def plaintext_from_numpy(poly, fmt: int = 1, level: int = 0,
                         noise_deg: int = 1, scale: float = 1.0,
                         slots: int = 0, encoding: str = "CKKS_PACKED",
                         values=None, scale_int: int = 1,
                         device=None) -> Plaintext:
    """poly: [k, N] uint32 words (EVAL when fmt is 1); the rest is the
    JAX plaintext's metadata."""
    return Plaintext(poly=u32_tensor(poly, resolve_device(device)), fmt=fmt,
                     level=level, noise_deg=noise_deg, scale=scale,
                     slots=slots, encoding=encoding, values=values,
                     scale_int=int(scale_int))


def _i32(x, dev):
    """Signed words (an LWE secret, a permutation table) as int32."""
    return u32_tensor(np.asarray(x).astype(np.int64).astype(np.int32), dev)


def lwe_secret_from_numpy(s, device=None) -> lwe.LWEPrivateKey:
    """s: [n] (or [N]) signed LWE secret."""
    return lwe.LWEPrivateKey(s=_i32(s, resolve_device(device)))


def lwe_public_key_from_numpy(A, v, device=None) -> lwe.LWEPublicKey:
    """A: [N, N], v: [N] uint32 words mod Q."""
    dev = resolve_device(device)
    return lwe.LWEPublicKey(A=u32_tensor(A, dev), v=u32_tensor(v, dev))


def switching_key_from_numpy(a, b, mod_ks: int, base_ks: int,
                             device=None) -> lwe.LWESwitchingKey:
    """a: [N, baseKS, d, n], b: [N, baseKS, d] uint32 words mod qKS."""
    dev = resolve_device(device)
    return lwe.LWESwitchingKey(a=u32_tensor(a, dev), b=u32_tensor(b, dev),
                               mod_ks=int(mod_ks), base_ks=int(base_ks))


def lwe_ciphertext_from_numpy(a, b, modulus: int, pt_modulus: int = 4,
                              device=None) -> lwe.LWECiphertext:
    """a: [..., n], b: [...] uint32 words mod `modulus`."""
    dev = resolve_device(device)
    return lwe.LWECiphertext(a=u32_tensor(a, dev), b=u32_tensor(b, dev),
                             modulus=int(modulus), pt_modulus=int(pt_modulus))


def bt_key_from_numpy(method, bt_key, device=None):
    """A blind-rotation key in the JAX package's form for `method`: GINX
    the tensor [n, 2, d2, 2, N]; AP (ek [n, dR, BR, d2, 2, N], digits_r);
    LMKCDEY (key_bank, perm_table, w)."""
    dev = resolve_device(device)
    method = BINFHE_METHOD(getattr(method, "value", method))
    if method == BINFHE_METHOD.GINX:
        return u32_tensor(bt_key, dev)
    if method == BINFHE_METHOD.AP:
        ek, digits_r = bt_key
        return u32_tensor(ek, dev), int(digits_r)
    key_bank, perm_table, w = bt_key
    return u32_tensor(key_bank, dev), _i32(perm_table, dev), int(w)


def to_numpy(x) -> np.ndarray:
    """A port tensor (int32 bits) -> numpy uint32 words."""
    return to_u32(x)
