"""The port's serialization and EvalHermiteTrigSeries against the JAX
package.

`openfhe_tpu_torch.utils.serialization` writes the JAX package's format
byte for byte. For the same words and metadata, the port's `serialize` of
every object type the JAX package writes (Ciphertext, Plaintext,
PublicKey, PrivateKey, EvalKey, the three LWE types, NdArray and
TensorTuple), binary and JSON, must equal JAX's bytes; JAX's blobs load in
the port and the port's in JAX with equal words; the eval-key maps and
the context record too, with the factory's dedup per device. A
deserialized relinearization key gets its Shoup companions back, so its
EvalMult through the fused chain (tables attached on the CPU) gives the
original key's words; a ciphertext's metadata map, which the JAX format
drops, is written only when it is not empty. The Hermite coefficients are
the JAX package's bit for bit, and EvalHermiteTrigSeries decrypts to
JAX's values within 1e-6 and to the series in numpy within 1e-3 (the
context of `tests/test_serialize_pre_multiparty.py::ckks`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openfhe_tpu.binfhe import lwe as jlwe  # noqa: E402
from openfhe_tpu.math import hermite as jhermite  # noqa: E402
from openfhe_tpu.utils import serialization as jser  # noqa: E402

from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch.binfhe import lwe  # noqa: E402
from openfhe_tpu_torch.math import hermite  # noqa: E402
from openfhe_tpu_torch.math.modops import u32_tensor  # noqa: E402
from openfhe_tpu_torch.utils import serialization as ser  # noqa: E402
from test_torch_multiparty import (CKKS, ct, jax_context, pk,  # noqa: E402
                                   port_context, sk, with_fused_tables,
                                   words_equal)

SERTYPES = ("BINARY", "JSON")


@pytest.fixture(scope="module")
def side():
    jcc = jax_context(3, **CKKS)
    kp = jcc.KeyGen()
    jcc.EvalMultKeyGen(kp.secret_key)
    jcc.EvalRotateKeyGen(kp.secret_key, [1, -1])
    x = np.linspace(0, 1, jcc.slots)
    pt = jcc.MakeCKKSPackedPlaintext(x)
    jct = jcc.Encrypt(kp.public_key, pt)
    cc = port_context(3, **CKKS)
    tag = kp.secret_key.key_tag
    moduli = cc.basis_qp.moduli
    cc.InsertEvalMultKey(convert.eval_key_from_jax(
        jcc.eval_mult_keys[tag], moduli, device="cpu"), tag)
    cc.InsertEvalAutomorphismKey(convert.eval_key_map_from_numpy(
        jcc.eval_automorphism_keys[tag], device="cpu", moduli_qp=moduli), tag)
    return dict(jcc=jcc, cc=cc, kp=kp, x=x, pt=pt, ct=jct, tag=tag)


def pairs(side):
    """(name, JAX object, the port's object of the same words)."""
    jcc, cc, kp, tag = side["jcc"], side["cc"], side["kp"], side["tag"]
    pt = side["pt"]
    rng = np.random.default_rng(2)
    words = lambda *shape: rng.integers(0, 1 << 32, shape, dtype=np.uint64
                                        ).astype(np.uint32)
    a, b, s = words(3, 16), words(3), rng.integers(-1, 2, 16, dtype=np.int32)
    ka, kb = words(4, 2, 3, 16), words(4, 2, 3)
    arr, bank = words(2, 5), words(3, 4)
    perm = rng.integers(-9, 9, (3, 2), dtype=np.int32)
    return [
        ("Ciphertext", side["ct"], ct(side["ct"])),
        ("Plaintext", pt, convert.plaintext_from_numpy(
            np.asarray(pt.poly), fmt=pt.fmt, level=pt.level,
            noise_deg=pt.noise_deg, scale=pt.scale, slots=pt.slots,
            encoding=pt.encoding, scale_int=pt.scale_int, device="cpu")),
        ("PublicKey", kp.public_key, pk(kp.public_key)),
        ("PrivateKey", kp.secret_key, sk(kp.secret_key)),
        ("EvalKey", jcc.eval_mult_keys[tag], cc.eval_mult_keys[tag]),
        ("LWECiphertext",
         jlwe.LWECiphertext(a=jnp.asarray(a), b=jnp.asarray(b), modulus=1024,
                            pt_modulus=4),
         lwe.LWECiphertext(a=u32_tensor(a), b=u32_tensor(b), modulus=1024,
                           pt_modulus=4)),
        ("LWEPrivateKey", jlwe.LWEPrivateKey(s=jnp.asarray(s)),
         lwe.LWEPrivateKey(s=torch.from_numpy(s))),
        ("LWESwitchingKey",
         jlwe.LWESwitchingKey(a=jnp.asarray(ka), b=jnp.asarray(kb),
                              mod_ks=1 << 14, base_ks=32),
         lwe.LWESwitchingKey(a=u32_tensor(ka), b=u32_tensor(kb),
                             mod_ks=1 << 14, base_ks=32)),
        ("NdArray", jnp.asarray(arr), u32_tensor(arr)),
        ("TensorTuple", (jnp.asarray(bank), jnp.asarray(perm), 7),
         (u32_tensor(bank), perm, 7)),
        ("TensorTuple list", [jnp.asarray(bank), 2.5],
         [u32_tensor(bank), 2.5]),
    ]


@pytest.mark.parametrize("sertype", SERTYPES)
def test_bytes_equal_to_jax(side, sertype):
    """Every object type, the same bytes as the JAX package's."""
    st, jst = ser.SerType[sertype], jser.SerType[sertype]
    differ = [name for name, jobj, obj in pairs(side)
              if ser.serialize(obj, st) != jser.serialize(jobj, jst)]
    assert not differ, differ


@pytest.mark.parametrize("sertype", SERTYPES)
def test_blobs_load_both_ways(side, sertype):
    """JAX's blobs load in the port (on the CPU, EvalKeys with their
    companions over the context's QP) and the port's in JAX, with equal
    words."""
    st, jst = ser.SerType[sertype], jser.SerType[sertype]
    cc = side["cc"]
    for name, jobj, obj in pairs(side):
        got = ser.deserialize(jser.serialize(jobj, jst), st, device="cpu",
                              cc=cc)
        back = jser.deserialize(ser.serialize(obj, st), jst)
        if name.startswith("TensorTuple"):
            assert type(got) is type(jobj) and len(got) == len(jobj)
            for g, b, w in zip(got, back, jobj):
                if isinstance(w, (int, float)):
                    assert g == b == w
                else:
                    np.testing.assert_array_equal(
                        np.asarray(g).view(np.asarray(w).dtype)
                        if isinstance(g, torch.Tensor) else g, np.asarray(w))
                    np.testing.assert_array_equal(np.asarray(b),
                                                  np.asarray(w))
            continue
        fields = {"LWECiphertext": ("a", "b"), "LWEPrivateKey": ("s",),
                  "LWESwitchingKey": ("a", "b"), "NdArray": (None,)}.get(name)
        if fields is None:
            words_equal(got, jobj)
            words_equal(obj, back)
            continue
        for f in fields:
            w = np.asarray(jobj if f is None else getattr(jobj, f))
            g = got if f is None else getattr(got, f)
            np.testing.assert_array_equal(g.numpy().view(w.dtype), w)
            np.testing.assert_array_equal(
                np.asarray(back if f is None else getattr(back, f)), w)


def test_eval_key_maps(side):
    """SerializeEvalMultKey / EvalAutomorphismKey / EvalSumKey are JAX's
    strings; reloading gives the words with companions on the context's
    device."""
    jcc, cc, tag = side["jcc"], side["cc"], side["tag"]
    assert cc.SerializeEvalMultKey() == jcc.SerializeEvalMultKey()
    auto = cc.SerializeEvalAutomorphismKey()
    assert auto == jcc.SerializeEvalAutomorphismKey()
    assert cc.SerializeEvalSumKey() == auto
    fresh = port_context(3, **CKKS)
    fresh.DeserializeEvalMultKey(jcc.SerializeEvalMultKey())
    fresh.DeserializeEvalAutomorphismKey(auto)
    words_equal(fresh.eval_mult_keys[tag], jcc.eval_mult_keys[tag])
    gs = sorted(jcc.eval_automorphism_keys[tag])
    assert sorted(fresh.eval_automorphism_keys[tag]) == gs
    words_equal([fresh.eval_automorphism_keys[tag][g] for g in gs],
                [jcc.eval_automorphism_keys[tag][g] for g in gs])
    assert fresh.eval_mult_keys[tag].bv.device.type == "cpu"


def test_context_record_and_dedup(side):
    """The record is JAX's string; a record deserializes to one context
    per parameters and device, JAX's record too."""
    jcc, cc = side["jcc"], side["cc"]
    record = ser.serialize_context(cc)
    assert record == jser.serialize_context(jcc)
    assert ser.serialize(cc) == jser.serialize(jcc)
    ser.CryptoContextFactory.release_all_contexts()
    c1 = ser.deserialize_context(record, device="cpu")
    c2 = ser.deserialize(jser.serialize_context(jcc).encode(), device="cpu")
    assert c1 is c2 and c1.device.type == "cpu"
    assert c1.moduli_q == cc.moduli_q and c1.params == cc.params
    ser.CryptoContextFactory.release_all_contexts()
    assert ser.deserialize_context(record, device="cpu") is not c1
    ser.CryptoContextFactory.release_all_contexts()


def test_reloaded_relin_key_runs_the_fused_chain(side):
    """A reloaded relinearization key's EvalMult, through the fused chain
    (tables attached on the CPU), gives the original key's words; without
    a context a key cannot be given its companions."""
    cc, tag = side["cc"], side["tag"]
    fused = with_fused_tables(port_context(3, **CKKS))
    blob = ser.serialize(cc.eval_mult_keys[tag], ser.SerType.JSON)
    ek = ser.deserialize(blob, ser.SerType.JSON, cc=fused)
    assert ek.bv_sh is not None
    assert torch.equal(ek.bv_sh, cc.eval_mult_keys[tag].bv_sh)
    fused.InsertEvalMultKey(ek, tag)
    x = ct(side["ct"])
    assert fused.hybrid_tables(x.num_towers).fused is not None
    for a, b in zip(fused.EvalMult(x, x).elements, cc.EvalMult(x, x).elements):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="context"):
        ser.deserialize(blob, ser.SerType.JSON, device="cpu")


def test_ciphertext_metadata(side):
    """The metadata map travels when it is not empty (after the JAX
    package's fields, so JAX reads the rest); an empty one leaves JAX's
    bytes."""
    x = ct(side["ct"])
    assert ser.serialize(x) == jser.serialize(side["ct"])
    tagged = x.SetMetadataByKey("party", "alice").SetMetadataByKey("n", 3)
    for st in ser.SerType:
        back = ser.deserialize(ser.serialize(tagged, st), st, device="cpu")
        assert back.metadata == tagged.metadata
        words_equal(back, side["ct"].replace(metadata=tagged.metadata))
    words_equal(ct(jser.deserialize(ser.serialize(tagged))), side["ct"])


def test_hermite_coefficients_match_jax():
    """The coefficients, orders 1-3, bit for bit. Order 2 at an odd p
    fails in the JAX package (an IndexError: omega indexed past its end)
    and is refused by the port (a ValueError)."""
    funcs = {"square mod 5": lambda j: j * j % 5, "step": lambda j: j > 2,
             "sign": lambda j: 1.0 if j < 4 else -1.0}
    for name, f in funcs.items():
        for p, order in ((5, 1), (5, 3), (8, 1), (8, 2), (8, 3), (6, 2)):
            got = hermite.get_hermite_trig_coefficients(f, p, order, 2.0)
            want = jhermite.get_hermite_trig_coefficients(f, p, order, 2.0)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                          err_msg=f"{name} p={p}")
    with pytest.raises(IndexError):
        jhermite.get_hermite_trig_coefficients(abs, 5, 2)
    for p, order in ((5, 2), (0, 1), (4, 4)):
        with pytest.raises(ValueError):
            hermite.get_hermite_trig_coefficients(abs, p, order)


def test_eval_hermite_trig_series(side):
    """EvalHermiteTrigSeries of x^2 mod 4 (p = 4, order 1: degree 3) on an
    encryption of exp(2 pi i x / 4): the port's decryption within 1e-6 of
    JAX's and within 1e-3 of the series evaluated in numpy."""
    jcc, cc, kp = side["jcc"], side["cc"], side["kp"]
    p = 4
    f = lambda j: j * j % p
    z = np.exp(2j * np.pi * (np.arange(jcc.slots) % p) / p)
    jct = jcc.Encrypt(kp.public_key, jcc.MakeCKKSPackedPlaintext(z))
    want = jcc.Decrypt(kp.secret_key, jcc.EvalHermiteTrigSeries(jct, f, p))
    got = cc.Decrypt(sk(kp.secret_key),
                     cc.EvalHermiteTrigSeries(ct(jct), f, p))
    assert np.abs(got.values - want.values).max() < 1e-6
    series = sum(complex(c) * z ** j for j, c in enumerate(
        hermite.get_hermite_trig_coefficients(f, p)))
    assert np.abs(got.values - series).max() < 1e-3
