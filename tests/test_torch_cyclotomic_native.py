"""The port's arbitrary-cyclotomic transforms and native host library.

On the CPU, word for word against the JAX package: `cyclotomic_poly`,
`bluestein_fft` and the arbitrary-order CRT transforms at m = 5, 12, 15,
22, 45 and 1001 (the port's convolution runs on `ops/ntt`'s plain twins
here, kernels m and a/b on the card); each of the five functions of
`native/fhe_host.cpp` through the port's own build against its Python
twin and the JAX package's; `crt.interpolate_centered_float`,
`crt.to_residues_host` and `packed._host_ntt` taking the native path, the
decode's two faults kept out (a value near +-Q/2 signed by the top digit
alone, NaN past 2^1024); and a failed build raising.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openfhe_tpu import native as jnative  # noqa: E402
from openfhe_tpu.math import crt as jcrt  # noqa: E402
from openfhe_tpu.math import cyclotomic as jcy  # noqa: E402
from openfhe_tpu.pke.encoding import packed as jpacked  # noqa: E402

from openfhe_tpu_torch import _build, native  # noqa: E402
from openfhe_tpu_torch.math import crt  # noqa: E402
from openfhe_tpu_torch.math import cyclotomic as cy  # noqa: E402
from openfhe_tpu_torch.math import nbtheory as nb  # noqa: E402
from openfhe_tpu_torch.ops import ntt  # noqa: E402
from openfhe_tpu_torch.pke.encoding import packed  # noqa: E402


def _moduli(count, bits=30, order=2048):
    mods, q = [], 1 << bits
    while len(mods) < count:
        q = nb.previous_prime(q, order)
        mods.append(q)
    return mods


def _jax_lib():
    """The JAX package's native library, which its loader builds at first
    use beside its source; a worker that found another's build half
    written retries."""
    for _ in range(3):
        lib = jnative._load()
        if lib:
            return lib
        jnative._LIB = None
        time.sleep(2)
    pytest.fail("the JAX package's native library did not load")


def _residues(vals, mods):
    return np.array([[v % m for v in vals] for m in mods], np.uint32)


def test_cyclotomic_poly_matches_jax():
    for m in list(range(1, 121)) + [105, 4095]:
        assert cy.cyclotomic_poly(m) == jcy.cyclotomic_poly(m), m
    assert cy.cyclotomic_poly(12) == (1, 0, -1, 0, 1)
    assert min(cy.cyclotomic_poly(105)) == -2


@pytest.mark.parametrize("m", [5, 12, 15, 22, 45, 1001])
def test_transforms_match_jax(m):
    """Bluestein (forward and inverse; against the naive DFT for small m),
    the forward and inverse CRT transforms and multiply_arb give JAX's
    words; the inverse undoes the forward."""
    q = nb.first_prime(28, 2 * m)
    t = nb.totient(m)
    rng = np.random.default_rng(m)
    x = [int(v) for v in rng.integers(0, q, m)]
    a, b = ([int(v) for v in rng.integers(0, q, t)] for _ in range(2))
    root = nb.root_of_unity(m, q)
    fx = cy.bluestein_fft(x, q, root, device="cpu")
    assert fx == jcy.bluestein_fft(x, q, root)
    assert cy.bluestein_fft(fx, q, root, inverse=True, device="cpu") == x
    if m < 50:
        assert fx == [sum(x[j] * pow(root, j * k, q) for j in range(m)) % q
                      for k in range(m)]
    fa = cy.forward_transform_arb(a, q, m, device="cpu")
    assert fa == jcy.forward_transform_arb(a, q, m)
    assert cy.inverse_transform_arb(fa, q, m, device="cpu") == a
    assert cy.inverse_transform_arb(fa, q, m, device="cpu") == \
        jcy.inverse_transform_arb(fa, q, m)
    assert cy.multiply_arb(a, b, q, m, device="cpu") == \
        jcy.multiply_arb(a, b, q, m)


def test_native_functions_match_python_and_jax():
    """The five functions of the port's build: garner_digits (against
    Garner in Python ints), crt_interpolate_centered_double (JAX's word
    for word, within 2 ulps of the exact value's rounding),
    to_residues_i64, host_ntt (both directions) and switch_centered_u64
    (each word for word against its Python twin and JAX's library)."""
    jlib = _jax_lib()
    rng = np.random.default_rng(0)
    mods = _moduli(8)
    big = int(np.prod([int(m) for m in mods], dtype=object))
    vals = [int(v) for v in rng.integers(-2 ** 62, 2 ** 62, 2000)]
    vals += [int(v) * 2 ** 150 + 7 for v in rng.integers(-2 ** 60, 2 ** 60,
                                                          200)]
    res = _residues(vals, mods)
    digits = native.garner_digits(res, mods)
    for i, v in enumerate(vals[:300]):
        x, w = v % big, 1
        for j, m in enumerate(mods):
            assert int(digits[j, i]) == x // w % m
            w *= m
    got = native.crt_interpolate_centered_double(res, mods)
    np.testing.assert_array_equal(
        got, jnative.crt_interpolate_centered_double(res, mods))
    exact = crt._interpolate_centered_float_py(res, mods)
    assert (np.abs(got - exact) <= 2 * np.spacing(np.abs(exact))).all()
    v64 = rng.integers(-2 ** 63, 2 ** 63 - 1, 3000)
    want = crt._to_residues_host_py(v64, mods)
    np.testing.assert_array_equal(native.to_residues_i64(v64, mods), want)
    np.testing.assert_array_equal(jnative.to_residues_i64(v64, mods), want)
    for t, n in ((65537, 1 << 12), (786433, 1 << 13), (12289, 512)):
        psi, ipsi, ninv, _, _ = packed._host_tables(t, n)
        x = rng.integers(0, t, (3, n)).astype(np.uint64)
        for inverse in (False, True):
            got = native.host_ntt(x, t, psi, ipsi, ninv, inverse)
            np.testing.assert_array_equal(got, jnative.host_ntt(
                x, t, psi, ipsi, ninv, inverse))
            np.testing.assert_array_equal(
                got[1], packed._host_ntt_np(x[1], t, n, inverse))
    for q_from, q_to in (((1 << 40) + 15, (1 << 30) + 3),
                         (2 ** 61 - 1, 65537), (65537, 2 ** 61 - 1)):
        w = rng.integers(0, q_from, 2000, dtype=np.uint64)
        w[:3] = (0, q_from // 2, q_from // 2 + 1)
        got = native.switch_centered_u64(w, q_from, q_to)
        out = np.empty(len(w), np.uint64)
        jlib.switch_centered_u64(np.ascontiguousarray(w), q_from, q_to,
                                 len(w), out)
        np.testing.assert_array_equal(got, out)
        ref = []
        for v in w.tolist():
            c = v - q_from if v > q_from // 2 else v
            r = (abs(c) * q_to + q_from // 2) // q_from
            ref.append(-r % q_to if c < 0 else r % q_to)
        np.testing.assert_array_equal(got, np.array(ref, np.uint64))
    with pytest.raises(ValueError, match="residues of shape"):
        native.garner_digits(res[:3], mods)


def test_decode_keeps_the_native_faults_out():
    """Values within half a top digit of +-Q/2, which the native decode
    signs wrongly (JAX's does too), and a chain of 40 31-bit towers
    (Q > 2^1024), where it gives NaN: `interpolate_centered_float` gives
    the exact path's values there, and the native ones elsewhere."""
    _jax_lib()
    mods = _moduli(8)
    big = int(np.prod([int(m) for m in mods], dtype=object))
    w = big // mods[-1]
    edge = [big // 2 - w // 2 + 1, big // 2 + 1, big // 2 + w // 3,
            -(big // 2) + 5, 12345, -98765]
    res = _residues(edge, mods)
    raw = native.crt_interpolate_centered_double(res, mods)
    exact = crt._interpolate_centered_float_py(res, mods)
    assert (np.sign(raw) != np.sign(exact)).sum() == 3
    np.testing.assert_array_equal(jnative.crt_interpolate_centered_double(
        res, mods), raw)
    np.testing.assert_array_equal(crt.interpolate_centered_float(res, mods),
                                  exact)
    wide = _moduli(40, bits=31)
    res = _residues([5, -7, 123456789], wide)
    assert np.isnan(jnative.crt_interpolate_centered_double(res, wide)).all()
    np.testing.assert_array_equal(crt.interpolate_centered_float(res, wide),
                                  [5.0, -7.0, 123456789.0])
    np.testing.assert_array_equal(
        crt.interpolate_centered_float(res, wide),
        jcrt.to_float(jcrt.interpolate_centered(res, wide)))


def test_crt_and_packed_take_the_native_path(monkeypatch):
    """The decode, the int64 residue lift and the packed encoding's NTT
    call the native library (object arrays take Python ints), with JAX's
    results."""
    calls = []
    for name in ("crt_interpolate_centered_double", "to_residues_i64",
                 "host_ntt"):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    mods = _moduli(5)
    rng = np.random.default_rng(1)
    res = rng.integers(0, 1 << 29, (5, 256)).astype(np.uint32)
    np.testing.assert_array_equal(crt.interpolate_centered_float(res, mods),
                                  jcrt.interpolate_centered_float(res, mods))
    v = rng.integers(-2 ** 40, 2 ** 40, 256)
    np.testing.assert_array_equal(crt.to_residues_host(v, mods),
                                  jcrt.to_residues_host(v, mods))
    big = np.array([int(x) * 2 ** 90 for x in v], object)
    np.testing.assert_array_equal(crt.to_residues_host(big, mods),
                                  jcrt.to_residues_host(big, mods))
    vals = rng.integers(0, 65537, 1024)
    coeffs = packed.encode_packed(vals, 65537, 1024)
    np.testing.assert_array_equal(coeffs,
                                  jpacked.encode_packed(vals, 65537, 1024))
    np.testing.assert_array_equal(packed.decode_packed(coeffs, 65537, 1024),
                                  vals)
    assert calls == ["crt_interpolate_centered_double", "to_residues_i64",
                     "host_ntt", "host_ntt"]


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails, or is missing, raises (no Python fallback);
    the library is then built and loaded again as before."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    try:
        for cxx, match in (("false", "failed to build"),
                           (str(tmp_path / "no-such-cxx"), "cannot run")):
            monkeypatch.setattr(native, "CXX", cxx)
            native.load.cache_clear()
            with pytest.raises(RuntimeError, match=match):
                native.crt_interpolate_centered_double(
                    np.zeros((1, 4), np.uint32), [17])
        assert not list(tmp_path.glob("*.so"))
    finally:
        native.load.cache_clear()
    monkeypatch.undo()
    assert native.to_residues_i64(np.array([-1]), [17])[0, 0] == 16


def test_ring_and_bluestein_run_the_ports_ntt(monkeypatch):
    """RingPoly.SetFormat and each Bluestein convolution go through
    `ops/ntt` (kernel m or a/b on the card, the plain twins here): a
    multiply_arb at m = 45 is three forward transforms of [2, k, 256] and
    three inverse ones."""
    from openfhe_tpu_torch.lattice.ringq import RingParams, RingPoly
    seen = []
    for name in ("ntt_fwd", "ntt_inv"):
        fn = getattr(ntt, name)
        monkeypatch.setattr(ntt, name, lambda x, b, _f=fn, _n=name: (
            seen.append((_n, tuple(x.shape))), _f(x, b))[1])
    ring = RingParams.create(256, 28, device="cpu")
    p = RingPoly.from_coeffs(ring, np.arange(256))
    assert p.SetFormat("EVALUATION").SetFormat("COEFFICIENT") == p
    assert seen == [("ntt_fwd", (1, 256)), ("ntt_inv", (1, 256))]
    seen.clear()
    m, q = 45, nb.first_prime(28, 90)
    cy.multiply_arb([1, 2, 3], [4, 5], q, m, device="cpu")
    k = len(cy._conv_primes(128, (2 * m * (q - 1) ** 2).bit_length()))
    assert seen == [("ntt_fwd", (2, k, 256)), ("ntt_inv", (k, 256))] * 3
