"""The port's packed, coefficient and string encodings against the JAX
package.

`openfhe_tpu_torch/pke/encoding/packed.py` is a host numpy module: the
exact negacyclic NTT mod t, its twiddles and slot maps, the packed
encode and decode, the coefficient and string encodings must equal the
JAX package's at N = 2^10 and 2^12 (t = 65537) and N=512 (t = 12289),
and decode the `packed` vectors of `tests/vectors/reference_vectors.json`
(dumped from the compiled reference) as the JAX package does. Then the
context's plaintext factories (MakePackedPlaintext at a level,
MakeCoefPackedPlaintext, MakeStringPlaintext, MakePlaintext) give the
JAX words in a BGV and a BFV context, and their encryptions decrypt to
the values.
"""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openfhe_tpu.pke import constants as jc  # noqa: E402
from openfhe_tpu.pke.encoding import packed as jpacked  # noqa: E402

from openfhe_tpu_torch.pke import constants as tc  # noqa: E402
from openfhe_tpu_torch.pke.encoding import packed  # noqa: E402
from test_torch_bgv import (assert_same, jax_context,  # noqa: E402
                            port_context)

SHAPES = [(1 << 10, 65537), (1 << 12, 65537), (512, 12289)]
VECTORS = pathlib.Path(__file__).parent / "vectors" / "reference_vectors.json"


@pytest.mark.parametrize("n,t", SHAPES)
def test_tables_and_host_ntt_match_jax(n, t):
    for got, want in zip(packed._host_tables(t, n),
                         jpacked._host_tables(t, n)):
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(n)
    a = rng.integers(0, t, n)
    for inverse in (False, True):
        np.testing.assert_array_equal(
            packed._host_ntt(a, t, n, inverse),
            jpacked._host_ntt(a, t, n, inverse).astype(np.uint64))


@pytest.mark.parametrize("n,t", SHAPES)
def test_encode_decode_match_jax(n, t):
    rng = np.random.default_rng(t)
    for length in (n, n // 2 + 3, 5):
        v = rng.integers(-t, t, length)
        coeffs = packed.encode_packed(v, t, n)
        np.testing.assert_array_equal(coeffs,
                                      jpacked.encode_packed(v, t, n))
        back = packed.decode_packed(coeffs, t, n)
        np.testing.assert_array_equal(back, jpacked.decode_packed(coeffs,
                                                                  t, n))
        np.testing.assert_array_equal(back[:length], np.mod(v, t))
        assert not back[length:].any()
    with pytest.raises(ValueError, match="too many slots"):
        packed.encode_packed(np.zeros(n + 1, np.int64), t, n)


@pytest.mark.parametrize("n,t", SHAPES)
def test_coef_and_string_encodings_match_jax(n, t):
    v = np.arange(-7, 20)
    np.testing.assert_array_equal(packed.coef_encode(v, t, n),
                                  jpacked.coef_encode(v, t, n))
    c = packed.coef_encode(v, t, n)
    np.testing.assert_array_equal(packed.coef_decode(c, t, n, len(v)),
                                  jpacked.coef_decode(c, t, n, len(v)))
    s = "BGV / BFV: héllo"
    e = packed.string_encode(s, t, n)
    np.testing.assert_array_equal(e, jpacked.string_encode(s, t, n))
    assert packed.string_decode(e, t, n) == jpacked.string_decode(e, t,
                                                                  n) == s


def test_reference_vectors_decode_as_jax_does():
    """The reference's packed coefficients (N = 2^10 and 2^12) decode with
    the port's tables to the JAX package's slots, which are the
    reference's up to its choice of root (tests/test_golden_vectors.py
    holds that part)."""
    for vec in json.loads(VECTORS.read_text())["packed"]:
        n, t = vec["n"], vec["t"]
        coeffs = np.array(vec["coeffs_mod_t"], np.uint64)
        got = packed.decode_packed(coeffs, t, n)
        np.testing.assert_array_equal(got,
                                      jpacked.decode_packed(coeffs, t, n))
        ref = np.sort(np.array(vec["slots"], np.int64))
        np.testing.assert_array_equal(np.sort(got), ref)
        np.testing.assert_array_equal(
            packed.decode_packed(packed.encode_packed(got, t, n), t, n),
            got)


# ---------------------------------------------------------------------------
# the context's plaintext factories
# ---------------------------------------------------------------------------

FACTORIES = {
    "packed": lambda cc, pe: cc.MakePackedPlaintext(np.arange(40) * 3 - 20),
    "packed_level1": lambda cc, pe: cc.MakePackedPlaintext(
        np.arange(1024) % 97, level=1),
    "coef": lambda cc, pe: cc.MakeCoefPackedPlaintext(np.arange(-9, 9)),
    "string": lambda cc, pe: cc.MakeStringPlaintext("openfhe"),
    "make_plaintext": lambda cc, pe: cc.MakePlaintext(
        pe.PACKED_ENCODING, [4, 5, 6]),
    "make_plaintext_coef": lambda cc, pe: cc.MakePlaintext(
        pe.COEF_PACKED_ENCODING, [1, -2, 3]),
}
SCHEMES = {"BGV": dict(scheme="BGVRNS_SCHEME", ring_dim=1024, mult_depth=2,
                       plaintext_modulus=65537),
           "BFV": dict(scheme="BFVRNS_SCHEME", ring_dim=1024, mult_depth=2,
                       plaintext_modulus=65537)}


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_factories_match_jax(scheme):
    jcc = jax_context(3, **SCHEMES[scheme])
    cc = port_context(3, **SCHEMES[scheme])
    for name, make in FACTORIES.items():
        if scheme == "BFV" and name == "packed_level1":
            continue                       # BFV has no levels
        got = make(cc, tc.PlaintextEncodings)
        want = make(jcc, jc.PlaintextEncodings)
        assert_same(got, want)


def test_coef_and_string_round_trip():
    """Encrypt and Decrypt of the coefficient and string plaintexts under
    BFV: the decryption's coefficients are the values (its slot view is
    the packed decode)."""
    cc = port_context(3, **SCHEMES["BFV"])
    kp = cc.KeyGen()
    t = cc.plaintext_modulus
    for pt, want in ((cc.MakeCoefPackedPlaintext([5, -3, 8]),
                      [5, t - 3, 8]),
                     (cc.MakeStringPlaintext("hi"), [ord("h"), ord("i")])):
        dec = cc.Decrypt(kp.secret_key, cc.Encrypt(kp.public_key, pt))
        coeffs = packed.encode_packed(dec.values, t, cc.ring_dim)
        np.testing.assert_array_equal(coeffs[:len(want)], want)
        assert not coeffs[len(want):].any()
