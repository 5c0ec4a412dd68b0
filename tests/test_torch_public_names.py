"""The small public names of the port against their JAX counterparts, and
the examples' device rule.

`replace` on every user-facing value class (flax's `struct.dataclass`
gives the JAX ones theirs), `Ciphertext.with_elements`,
`PrivateKey.s_q`, `KeyPair.good`, `CryptoContext.is_enabled` /
`basis_at_size`, `Basis.big_modulus`, `crt.to_float`,
`automorph.CONJUGATION` / `rotation_generator` and
`ParallelControls.enable`, each on the same inputs in both packages. Then
every example of `examples_torch/` refuses to run without a card unless
asked for the CPU.
"""

import dataclasses
import importlib
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from openfhe_tpu import parallel as jpar  # noqa: E402
from openfhe_tpu.binfhe import lwe as jlwe  # noqa: E402
from openfhe_tpu.lattice import automorph as jauto  # noqa: E402
from openfhe_tpu.lattice import basis as jbasis  # noqa: E402
from openfhe_tpu.math import crt as jcrt  # noqa: E402
from openfhe_tpu.pke import ciphertext as jct  # noqa: E402
from openfhe_tpu.pke import keys as jkeys  # noqa: E402

from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch import parallel as par  # noqa: E402
from openfhe_tpu_torch.lattice import automorph, basis  # noqa: E402
from openfhe_tpu_torch.math import crt  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32  # noqa: E402
from openfhe_tpu_torch.pke import keys  # noqa: E402
from test_torch_bgv import jax_context, port_context  # noqa: E402

CTX = dict(scheme="BGVRNS_SCHEME", plaintext_modulus=65537, mult_depth=3,
           ring_dim=256)
RNG = np.random.default_rng(20)
MODULI = (65537, 114689, 147457)


def words(k=3, n=256):
    return RNG.integers(0, 65537, (k, n)).astype(np.uint32)


def fields(obj) -> dict:
    """Every field as numpy (tensors and JAX arrays) or as it is."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, tuple) and v and hasattr(v[0], "shape"):
            v = tuple(to_u32(e) if isinstance(e, torch.Tensor)
                      else np.asarray(e) for e in v)
        elif isinstance(v, torch.Tensor):
            v = to_u32(v) if v.dtype == torch.int32 else v.numpy()
        elif hasattr(v, "shape"):
            v = np.asarray(v)
        out[f.name] = v
    return out


def same_fields(port, jax):
    a, b = fields(port), fields(jax)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], tuple) and a[k] and isinstance(a[k][0],
                                                           np.ndarray):
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y.astype(x.dtype))
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k].astype(a[k].dtype))
        else:
            assert a[k] == b[k], k


def case_ciphertext_replace():
    e = (words(), words())
    j = jct.Ciphertext(elements=tuple(jnp.asarray(w) for w in e), level=1,
                       scale=2.0 ** 20, slots=8, key_tag="t")
    p = convert.ciphertext_from_jax(j, device="cpu")
    change = dict(level=2, scale=3.0, key_tag="u", metadata=(("k", 1),))
    same_fields(p.replace(**change), j.replace(**change))
    assert p.level == 1                   # a new value; the old one stays


def case_with_elements():
    e = (words(), words())
    j = jct.Ciphertext(elements=tuple(jnp.asarray(w) for w in e), level=1)
    p = convert.ciphertext_from_jax(j, device="cpu")
    same_fields(p.with_elements([p.elements[1]]),
                j.with_elements([j.elements[1]]))


def case_plaintext_replace():
    w = words()
    j = jct.Plaintext(poly=jnp.asarray(w), level=1, scale=4.0, slots=8)
    p = convert.plaintext_from_numpy(w, level=1, scale=4.0, slots=8,
                                     device="cpu")
    same_fields(p.replace(level=3, encoding="PACKED"),
                j.replace(level=3, encoding="PACKED"))


def case_keys_replace_and_s_q():
    s, b, a = words(), words(), words()
    js = jkeys.PrivateKey(s_qp=jnp.asarray(s), key_tag="a")
    ps = convert.private_key_from_numpy(s, "a", device="cpu")
    same_fields(ps.replace(key_tag="b"), js.replace(key_tag="b"))
    np.testing.assert_array_equal(to_u32(ps.s_q(2)), np.asarray(js.s_q(2)))
    jp = jkeys.PublicKey(b=jnp.asarray(b), a=jnp.asarray(a), key_tag="a")
    pp = convert.public_key_from_numpy(b, a, "a", device="cpu")
    same_fields(pp.replace(key_tag="c"), jp.replace(key_tag="c"))
    bv, av = words()[None], words()[None]
    je = jkeys.EvalKey(bv=jnp.asarray(bv), av=jnp.asarray(av), key_tag="a")
    pe = keys.EvalKey(bv=torch.from_numpy(bv.astype(np.int32)),
                      av=torch.from_numpy(av.astype(np.int32)), key_tag="a")
    same_fields(pe.replace(key_tag="d"), je.replace(key_tag="d"))
    jk = jkeys.KeyPair(public_key=jp, secret_key=js)
    pk = keys.KeyPair(public_key=pp, secret_key=ps)
    assert pk.replace(secret_key=None).secret_key is None
    assert jk.replace(secret_key=None).secret_key is None


def case_keypair_good():
    pp = convert.public_key_from_numpy(words(), words(), device="cpu")
    ps = convert.private_key_from_numpy(words(), device="cpu")
    for pub, sec in ((pp, ps), (None, ps), (pp, None), (None, None)):
        want = jkeys.KeyPair(public_key=pub, secret_key=sec).good
        assert keys.KeyPair(public_key=pub, secret_key=sec).good == want
    assert keys.KeyPair(pp, ps).good


def case_lwe_replace():
    s = RNG.integers(-1, 2, 16).astype(np.int32)
    js = jlwe.LWEPrivateKey(s=jnp.asarray(s))
    ps = convert.lwe_secret_from_numpy(s, device="cpu")
    s2 = -s
    same_fields(ps.replace(s=torch.from_numpy(s2)),
                js.replace(s=jnp.asarray(s2)))
    A, v = words(4, 4), words(1, 4)[0]
    jp = jlwe.LWEPublicKey(A=jnp.asarray(A), v=jnp.asarray(v))
    pp = convert.lwe_public_key_from_numpy(A, v, device="cpu")
    same_fields(pp.replace(v=torch.zeros(4, dtype=torch.int32)),
                jp.replace(v=jnp.zeros(4, jnp.uint32)))
    ka, kb = words(2, 3)[None], words(2, 3)[None, :, 0]
    jk = jlwe.LWESwitchingKey(a=jnp.asarray(ka), b=jnp.asarray(kb),
                              mod_ks=1024, base_ks=32)
    pk = convert.switching_key_from_numpy(ka, kb, 1024, 32, device="cpu")
    same_fields(pk.replace(base_ks=16), jk.replace(base_ks=16))


def case_is_enabled():
    jcc, cc = jax_context(3, **CTX), port_context(3, **CTX)
    from openfhe_tpu.pke.constants import PKESchemeFeature as JF
    from openfhe_tpu_torch import PKESchemeFeature as F
    for f in (F.PKE, F.KEYSWITCH, F.LEVELEDSHE):
        cc.Enable(f)
    for f in F:
        assert cc.is_enabled(f) == jcc.is_enabled(JF[f.name]), f.name


def case_basis_at_size():
    jcc, cc = jax_context(3, **CTX), port_context(3, **CTX)
    for k in range(1, len(cc.moduli_q) + 1):
        got, want = cc.basis_at_size(k), jcc.basis_at_size(k)
        assert got.moduli == tuple(want.moduli)
        np.testing.assert_array_equal(to_u32(got.psi_br),
                                      np.asarray(want.psi_br))


def case_big_modulus():
    got = basis.make_basis(MODULI, 256).big_modulus()
    assert got == jbasis.make_basis(MODULI, 256).big_modulus()
    assert got == 65537 * 114689 * 147457


def case_crt_to_float():
    vals = np.array([0, -1, 2 ** 80 + 3, -(2 ** 100), 12345], dtype=object)
    got = crt.to_float(vals)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jcrt.to_float(vals))


def case_automorph_names():
    assert automorph.CONJUGATION == jauto.CONJUGATION
    for n in (16, 256, 1 << 16):
        g = automorph.rotation_generator(n)
        assert g == jauto.rotation_generator(n)
        assert automorph.rotation_automorphism_index(1, n) == g


def case_parallel_enable():
    """Both say whether there is more than one device to shard over, but
    count different devices: JAX every JAX device (under tests/conftest.py
    the eight virtual CPU devices, so True here), the port only the cards
    (none here, so False); the port's CPU meshes are built on request
    (`make_mesh(devices=...)`), never found."""
    import jax
    assert jpar.ParallelControls().enable() == (len(jax.devices()) > 1)
    assert jpar.ParallelControls().enable()
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert par.ParallelControls().enable() == (n_cards > 1)
    assert par.OpenFHEParallelControls.enable() == (n_cards > 1)


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_public_name_matches_jax(name):
    CASES[name]()


EXAMPLES = sorted(p.stem for p in
                  (pathlib.Path(__file__).parents[1] / "examples_torch")
                  .glob("*.py") if p.stem != "__init__")


def test_every_example_refuses_the_cpu_unless_asked(monkeypatch):
    """All 53 examples, one for each of `examples/`: main() with no device
    raises before any work where there is no card (none is visible to the
    port here, whatever the host has)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jax_examples = sorted(p.stem for p in (
        pathlib.Path(__file__).parents[1] / "examples").glob("*.py"))
    assert EXAMPLES == jax_examples
    for name in EXAMPLES:
        mod = importlib.import_module(f"examples_torch.{name}")
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main()
