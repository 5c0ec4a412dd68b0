"""Serialization: versioned flat binary and JSON for every crypto object.

Counterpart of `openfhe_tpu/utils/serialization.py`, whose format it
writes byte for byte (reference analog: utils/serial.h, the cereal binary
and JSON archives; cryptocontext-ser.h:115-218, the context, key and
ciphertext records with the eval-key maps; cryptocontextfactory.h, the
context dedup on deserialize). Each object is a type tag, a version, its
metadata as JSON and its tensors as raw blobs:

    magic 'OFT1' | u32 header_len | header JSON (utf-8) | blob bytes ...

and JSON mode carries the blobs inline in base64. Residues are written as
dtype uint32 from the port's int32 words (the same bits); the LWE types
keep the JAX package's dtypes (uint32 words, an int32 secret). An int32
tensor is written as uint32 words; pass a numpy array to keep another
dtype.

The port adds two things. The deserializer puts tensors on the caller's
device, the card unless `device` is given. And an `EvalKey` comes back
with its Shoup companions, which the format does not carry, so that it
can run the fused key switch: give `cc`, the context whose QP moduli the
key lives over. A ciphertext's metadata map, which the JAX format drops,
is written (as "metadata" after the JAX package's fields) only when it is
not empty, so every object the JAX package can write stays byte-equal.
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import json
import struct as _struct

import numpy as np
import torch

from openfhe_tpu_torch._device import resolve_device
from openfhe_tpu_torch.binfhe import lwe as _lwe
from openfhe_tpu_torch.math.modops import u32_tensor
from openfhe_tpu_torch.pke.ciphertext import Ciphertext, Plaintext
from openfhe_tpu_torch.pke.keys import EvalKey, PrivateKey, PublicKey
from openfhe_tpu_torch.pke.keyswitch.hybrid import shoup_companions

MAGIC = b"OFT1"
VERSION = 1


class SerType(enum.Enum):
    BINARY = "BINARY"
    JSON = "JSON"


# ---------------------------------------------------------------------------
# objects <-> (header, blobs)
# ---------------------------------------------------------------------------

def _host(x, dtype: str | None = "uint32") -> np.ndarray:
    """A tensor as the numpy array the format writes: int32 words as
    `dtype` (uint32 residues, int32 for a signed secret), other dtypes as
    they are; a numpy array as it is."""
    if isinstance(x, np.ndarray):
        return x
    a = x.detach().cpu().contiguous().numpy()
    return a.view(np.dtype(dtype)) if a.dtype == np.int32 and dtype else a


def _array_entry(name, arr, blobs):
    a = np.asarray(arr)
    offset = sum(len(b) for b in blobs)
    blobs.append(a.tobytes())
    return {"name": name, "dtype": str(a.dtype), "shape": list(a.shape),
            "offset": offset, "nbytes": a.nbytes}


def _pack(type_name: str, meta: dict, arrays: dict) -> tuple:
    blobs = []
    entries = [_array_entry(k, v, blobs) for k, v in arrays.items()]
    header = {"type": type_name, "version": VERSION, "meta": meta,
              "arrays": entries}
    return header, b"".join(blobs)


def _unpack_arrays(header, blob, device) -> dict:
    """The blobs as tensors on `device`: uint32 words as the port's int32
    words, other dtypes as they are."""
    out = {}
    for e in header["arrays"]:
        a = np.frombuffer(blob[e["offset"]:e["offset"] + e["nbytes"]],
                          dtype=e["dtype"]).reshape(e["shape"])
        out[e["name"]] = (u32_tensor(a, device) if a.dtype == np.uint32
                          else torch.from_numpy(a.copy()).to(device))
    return out


def _obj_to_parts(obj):
    if isinstance(obj, Ciphertext):
        meta = {"level": obj.level, "noise_deg": obj.noise_deg,
                "scale": obj.scale, "slots": obj.slots,
                "key_tag": obj.key_tag, "encoding": obj.encoding,
                "scale_int": obj.scale_int, "n_elements": len(obj.elements)}
        if obj.metadata:
            meta["metadata"] = [list(kv) for kv in obj.metadata]
        arrays = {f"c{i}": _host(e) for i, e in enumerate(obj.elements)}
        return "Ciphertext", meta, arrays
    if isinstance(obj, Plaintext):
        meta = {"fmt": obj.fmt, "level": obj.level, "noise_deg": obj.noise_deg,
                "scale": obj.scale, "slots": obj.slots,
                "encoding": obj.encoding, "scale_int": obj.scale_int}
        return "Plaintext", meta, {"poly": _host(obj.poly)}
    if isinstance(obj, PublicKey):
        return "PublicKey", {"key_tag": obj.key_tag}, {"b": _host(obj.b),
                                                       "a": _host(obj.a)}
    if isinstance(obj, PrivateKey):
        return "PrivateKey", {"key_tag": obj.key_tag}, {"s_qp":
                                                        _host(obj.s_qp)}
    if isinstance(obj, EvalKey):
        return "EvalKey", {"key_tag": obj.key_tag}, {"bv": _host(obj.bv),
                                                     "av": _host(obj.av)}
    if isinstance(obj, _lwe.LWECiphertext):
        return "LWECiphertext", {"modulus": obj.modulus,
                                 "pt_modulus": obj.pt_modulus}, \
            {"a": _host(obj.a), "b": _host(obj.b)}
    if isinstance(obj, _lwe.LWEPrivateKey):
        return "LWEPrivateKey", {}, {"s": _host(obj.s, "int32")}
    if isinstance(obj, _lwe.LWESwitchingKey):
        return "LWESwitchingKey", {"mod_ks": obj.mod_ks,
                                   "base_ks": obj.base_ks}, \
            {"a": _host(obj.a), "b": _host(obj.b)}
    if isinstance(obj, dict):
        raise TypeError("use serialize_eval_mult_keys / "
                        "serialize_eval_automorphism_keys for key maps")
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        # a raw tensor (a BinFHE refresh key, which is one tensor)
        return "NdArray", {}, {"a": _host(obj)}
    if isinstance(obj, (tuple, list)):
        # fixed-shape tuples of tensors (the AP / LMKCDEY key bundles)
        metas, arrays = [], {}
        for i, item in enumerate(obj):
            if isinstance(item, (np.ndarray, torch.Tensor)):
                arrays[f"t{i}"] = _host(item)
                metas.append(None)
            elif isinstance(item, (int, float)):
                metas.append(item)
            else:
                raise TypeError(f"cannot serialize tuple item {type(item)}")
        return "TensorTuple", {"items": metas,
                               "is_list": isinstance(obj, list)}, arrays
    raise TypeError(f"cannot serialize {type(obj)}")


def _eval_key(arrays, key_tag: str, cc) -> EvalKey:
    """An EvalKey with its companions over cc's QP moduli."""
    if cc is None:
        raise ValueError("deserializing an EvalKey needs its context "
                         "(cc=...): the format carries no Shoup companions "
                         "and the fused key switch needs them")
    ek = EvalKey(bv=arrays["bv"], av=arrays["av"], key_tag=key_tag)
    if ek.bv.shape[-2] != cc.basis_qp.k:
        raise ValueError(f"the key has {ek.bv.shape[-2]} towers, the "
                         f"context's QP {cc.basis_qp.k}")
    return shoup_companions(ek, cc.basis_qp.moduli)


def _parts_to_obj(header, arrays, cc):
    t = header["type"]
    m = header["meta"]
    if t == "Ciphertext":
        elems = tuple(arrays[f"c{i}"] for i in range(m["n_elements"]))
        return Ciphertext(elements=elems, level=m["level"],
                          noise_deg=m["noise_deg"], scale=m["scale"],
                          slots=m["slots"], key_tag=m["key_tag"],
                          encoding=m["encoding"], scale_int=m["scale_int"],
                          metadata=tuple(tuple(kv) for kv in
                                         m.get("metadata", ())))
    if t == "Plaintext":
        return Plaintext(poly=arrays["poly"], fmt=m["fmt"], level=m["level"],
                         noise_deg=m["noise_deg"], scale=m["scale"],
                         slots=m["slots"], encoding=m["encoding"],
                         scale_int=m["scale_int"])
    if t == "PublicKey":
        return PublicKey(b=arrays["b"], a=arrays["a"], key_tag=m["key_tag"])
    if t == "PrivateKey":
        return PrivateKey(s_qp=arrays["s_qp"], key_tag=m["key_tag"])
    if t == "EvalKey":
        return _eval_key(arrays, m["key_tag"], cc)
    if t == "LWECiphertext":
        return _lwe.LWECiphertext(a=arrays["a"], b=arrays["b"],
                                  modulus=m["modulus"],
                                  pt_modulus=m["pt_modulus"])
    if t == "LWEPrivateKey":
        return _lwe.LWEPrivateKey(s=arrays["s"])
    if t == "LWESwitchingKey":
        return _lwe.LWESwitchingKey(a=arrays["a"], b=arrays["b"],
                                    mod_ks=m["mod_ks"], base_ks=m["base_ks"])
    if t == "NdArray":
        return arrays["a"]
    if t == "TensorTuple":
        out = [arrays[f"t{i}"] if mv is None else mv
               for i, mv in enumerate(m["items"])]
        return out if m.get("is_list") else tuple(out)
    raise TypeError(f"unknown serialized type {t}")


# ---------------------------------------------------------------------------
# the public API (Serial:: parity)
# ---------------------------------------------------------------------------

def serialize(obj, sertype: SerType = SerType.BINARY):
    from openfhe_tpu_torch.pke.context import CryptoContext
    if isinstance(obj, CryptoContext):
        # a context is its parameter record (reference: contexts serialize
        # as CCParams and dedup through the factory)
        s = serialize_context(obj)
        return s.encode() if sertype == SerType.BINARY else s
    header, blob = _pack(*_obj_to_parts(obj))
    if sertype == SerType.BINARY:
        h = json.dumps(header).encode()
        return MAGIC + _struct.pack("<I", len(h)) + h + blob
    header["blob_b64"] = base64.b64encode(blob).decode()
    return json.dumps(header)


def deserialize(data, sertype: SerType = SerType.BINARY, device=None,
                cc=None):
    """The object on `device` (cc's device when a context is given, else
    the card); a context record gives its deduplicated context. An
    EvalKey needs `cc` for its companions."""
    if data[:1] in (b"{", "{"):          # a context record, JSON either way
        s = data.decode() if isinstance(data, bytes) else data
        if '"CryptoContext"' in s[:64]:
            return deserialize_context(s, device=device)
    dev = resolve_device(device if device is not None or cc is None
                         else cc.device)
    if sertype == SerType.BINARY:
        if data[:4] != MAGIC:
            raise ValueError("bad magic")
        (hlen,) = _struct.unpack("<I", data[4:8])
        header = json.loads(data[8:8 + hlen].decode())
        blob = data[8 + hlen:]
    else:
        header = json.loads(data)
        blob = base64.b64decode(header.pop("blob_b64"))
    return _parts_to_obj(header, _unpack_arrays(header, blob, dev), cc)


def serialize_to_file(path: str, obj, sertype: SerType = SerType.BINARY):
    data = serialize(obj, sertype)
    with open(path, "wb" if sertype == SerType.BINARY else "w") as f:
        f.write(data)


def deserialize_from_file(path: str, sertype: SerType = SerType.BINARY,
                          device=None, cc=None):
    with open(path, "rb" if sertype == SerType.BINARY else "r") as f:
        return deserialize(f.read(), sertype, device=device, cc=cc)


# ---------------------------------------------------------------------------
# eval-key maps (reference SerializeEvalMultKey /
# SerializeEvalAutomorphismKey): JSON of base64 binary blobs
# ---------------------------------------------------------------------------

def serialize_eval_mult_keys(cc, sertype=SerType.BINARY) -> str:
    items = {tag: base64.b64encode(serialize(ek)).decode()
             for tag, ek in cc.eval_mult_keys.items()}
    return json.dumps({"type": "EvalMultKeyMap", "keys": items})


def deserialize_eval_mult_keys(cc, data) -> None:
    """The keys into cc's store, on cc's device with their companions."""
    d = json.loads(data)
    if d["type"] != "EvalMultKeyMap":
        raise ValueError(f"not an EvalMultKeyMap: {d['type']}")
    for tag, b in d["keys"].items():
        cc.eval_mult_keys[tag] = deserialize(base64.b64decode(b), cc=cc)


def serialize_eval_automorphism_keys(cc, sertype=SerType.BINARY) -> str:
    items = {tag: {str(g): base64.b64encode(serialize(ek)).decode()
                   for g, ek in gs.items()}
             for tag, gs in cc.eval_automorphism_keys.items()}
    return json.dumps({"type": "EvalAutomorphismKeyMap", "keys": items})


def deserialize_eval_automorphism_keys(cc, data) -> None:
    d = json.loads(data)
    if d["type"] != "EvalAutomorphismKeyMap":
        raise ValueError(f"not an EvalAutomorphismKeyMap: {d['type']}")
    for tag, gs in d["keys"].items():
        store = cc.eval_automorphism_keys.setdefault(tag, {})
        for g, b in gs.items():
            store[int(g)] = deserialize(base64.b64decode(b), cc=cc)


# ---------------------------------------------------------------------------
# the context record and the factory's dedup (cryptocontextfactory.h:56)
# ---------------------------------------------------------------------------

def _params_to_dict(params) -> dict:
    out = {}
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        out[f.name] = v.name if isinstance(v, enum.Enum) else v
    return out


def serialize_context(cc) -> str:
    return json.dumps({"type": "CryptoContext", "version": VERSION,
                       "params": _params_to_dict(cc.params), "seed": 0})


class CryptoContextFactory:
    """The context dedup cache (reference cryptocontextfactory.cpp):
    contexts deserialized from the same parameters onto the same device
    are one instance."""
    _cache: dict = {}

    @classmethod
    def get_context(cls, params, seed: int = 0, device=None):
        from openfhe_tpu_torch.pke.context import CryptoContext
        dev = resolve_device(device)
        key = (json.dumps(_params_to_dict(params), sort_keys=True), str(dev))
        if key not in cls._cache:
            cls._cache[key] = CryptoContext(params, seed=seed, device=dev)
        return cls._cache[key]

    @classmethod
    def release_all_contexts(cls):
        cls._cache.clear()


def deserialize_context(data: str, device=None):
    """The context of a record, deduplicated, on `device` (the card when
    None)."""
    from openfhe_tpu_torch.pke import constants as c
    from openfhe_tpu_torch.pke import parameters as prm
    d = json.loads(data)
    if d["type"] != "CryptoContext":
        raise ValueError(f"not a CryptoContext record: {d['type']}")
    enum_types = {
        "scheme": c.Scheme, "security_level": c.SecurityLevel,
        "secret_key_dist": c.SecretKeyDist,
        "ks_technique": c.KeySwitchTechnique,
        "scaling_technique": c.ScalingTechnique,
        "multiplication_technique": c.MultiplicationTechnique,
        "encryption_technique": c.EncryptionTechnique,
        "pre_mode": c.ProxyReEncryptionMode,
        "multiparty_mode": c.MultipartyMode,
        "execution_mode": c.ExecutionMode,
        "decryption_noise_mode": c.DecryptionNoiseMode,
        "ckks_data_type": c.CKKSDataType,
    }
    kw = {k: enum_types[k][v] if k in enum_types else v
          for k, v in d["params"].items()}
    return CryptoContextFactory.get_context(prm.CCParams(**kw),
                                            seed=d.get("seed", 0),
                                            device=device)
