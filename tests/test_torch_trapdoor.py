"""The port's ring, G-lattice sampling and trapdoors against the JAX package.

`lattice/ringq.py`, `lattice/dgsampling.py` and `lattice/trapdoor.py` at
n = 64 (base 32, 6 digits) and n = 256 (base 2, 28 digits) with a 28-bit
q, on the CPU. The JAX functions draw from a `Recorder`, a proxy of a
seeded `numpy.random.Generator` that keeps every variate it hands out
(standard normals for `normal`, checked to give numpy's own
`loc + scale * z` bit for bit); the port's functions replay them
(`math/draws.ReplayDraws`) and must give the JAX package's integers word
for word: RingPoly's EVALUATION words, TrapdoorGen's A and T, both
G-lattice samplers, ZSampleF, ZSampleSigma2x2, SampleMat and GaussSamp's
preimage, on JAX-made objects carried over by `convert` where the JAX
package made them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openfhe_tpu.lattice import dgsampling as jdgs  # noqa: E402
from openfhe_tpu.lattice import trapdoor as jtd  # noqa: E402
from openfhe_tpu.lattice.field2n import Field2n as JField2n  # noqa: E402
from openfhe_tpu.lattice.ringq import RingParams as JRingParams  # noqa
from openfhe_tpu.lattice.ringq import RingPoly as JRingPoly  # noqa: E402
from openfhe_tpu.math.matrix import Matrix as JMatrix  # noqa: E402
from openfhe_tpu.pke.encoding.packed import _host_ntt  # noqa: E402

from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch.lattice import dgsampling as dgs  # noqa: E402
from openfhe_tpu_torch.lattice import trapdoor as td  # noqa: E402
from openfhe_tpu_torch.lattice.field2n import Field2n  # noqa: E402
from openfhe_tpu_torch.lattice.ringq import RingParams, RingPoly  # noqa
from openfhe_tpu_torch.math.draws import ReplayDraws  # noqa: E402
from openfhe_tpu_torch.math.matrix import Matrix  # noqa: E402

RINGS = [(64, 32), (256, 2)]          # (n, base)


class Recorder:
    """A `numpy.random.Generator` proxy for the JAX functions, keeping
    what it hands out: uniforms, integers, and for `normal(loc, scale)`
    the standard normals z (asserting that numpy's result is
    loc + scale * z bit for bit)."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.recorded = []

    def random(self, size=None):
        x = self.rng.random(size)
        self.recorded.append(("random", np.atleast_1d(x)))
        return x

    def integers(self, low, high=None, size=None, dtype=np.int64):
        x = self.rng.integers(low, high, size, dtype=dtype)
        self.recorded.append(("integers", np.atleast_1d(x)))
        return x

    def normal(self, loc=0.0, scale=1.0, size=None):
        state = self.rng.bit_generator.state
        out = self.rng.normal(loc, scale, size)
        twin = np.random.Generator(type(self.rng.bit_generator)())
        twin.bit_generator.state = state
        z = twin.standard_normal(np.shape(out))
        assert np.array_equal(out, loc + scale * z), \
            "numpy's normal is not loc + scale * standard_normal"
        self.recorded.append(("normal", z))
        return out

    def replay(self, device="cpu") -> ReplayDraws:
        return ReplayDraws(self.recorded, device)


def words(p) -> np.ndarray:
    """A port RingPoly's words as the JAX package's uint64."""
    return p.data.cpu().numpy().astype(np.uint64)


def same_matrix(port: Matrix, jax_m) -> bool:
    return (port.rows, port.cols) == (jax_m.rows, jax_m.cols) and all(
        np.array_equal(words(port(r, c)), jax_m(r, c).data)
        for r in range(port.rows) for c in range(port.cols))


def rings(n):
    jring = JRingParams.create(n, n_bits=28)
    ring = RingParams.create(n, n_bits=28, device="cpu")
    assert ring.q == jring.q
    return jring, ring


@pytest.mark.parametrize("n", [64, 256, 4096])
def test_ring_poly_words(n):
    """SetFormat (the port's NTT) gives `_host_ntt`'s EVALUATION words and
    back; +, -, *, negation, Transpose, centered and Norm give JAX's."""
    jring, ring = rings(n)
    rng = np.random.default_rng(n)
    a, b = (rng.integers(-ring.q, ring.q, n) for _ in range(2))
    ja, jb = JRingPoly.from_coeffs(jring, a), JRingPoly.from_coeffs(jring, b)
    pa, pb = RingPoly.from_coeffs(ring, a), RingPoly.from_coeffs(ring, b)
    ea, eb = pa.SetFormat("EVALUATION"), pb.SetFormat("EVALUATION")
    np.testing.assert_array_equal(
        words(ea), _host_ntt(ja.data, jring.q, n, inverse=False))
    np.testing.assert_array_equal(words(ea.SetFormat("COEFFICIENT")),
                                  ja.data)
    jea, jeb = ja.SetFormat("EVALUATION"), jb.SetFormat("EVALUATION")
    for got, want in ((ea + eb, jea + jeb), (ea - eb, jea - jeb),
                      (ea * eb, jea * jeb), (-ea, -jea), (ea * 7, jea * 7),
                      (ea + 5, jea + 5), (pa - 3, ja - 3),
                      (ea.Transpose(), jea.Transpose()),
                      (pa.Transpose(), ja.Transpose())):
        assert got.fmt == want.fmt
        np.testing.assert_array_equal(words(got), want.data)
    np.testing.assert_array_equal(ea.centered().numpy(), jea.centered())
    assert ea.Norm() == jea.Norm()
    carried = convert.ring_poly_from_numpy(jea.data, jring.q, device="cpu")
    assert carried == ea


@pytest.mark.parametrize("n,base", RINGS)
def test_trapdoor_gen_words(n, base):
    """TrapdoorGen's A and (r, e) on JAX's draws; A [e; r; I] == g."""
    jring, ring = rings(n)
    rec = Recorder(n + base)
    jA, jT = jtd.trapdoor_gen(jring, jdgs.SIGMA, base, rng=rec)
    draws = rec.replay()
    A, T = td.trapdoor_gen(ring, dgs.SIGMA, base, draws=draws)
    assert draws.exhausted()
    k = td.gadget_k(ring.q, base)
    assert k == jtd.gadget_k(jring.q, base)
    assert same_matrix(A, jA)
    assert same_matrix(T.m_r, jT.m_r) and same_matrix(T.m_e, jT.m_e)
    alloc = lambda: RingPoly(ring, None, "EVALUATION")
    stack = T.m_e.VStack(T.m_r).VStack(Matrix(alloc, k, k).Identity())
    assert A.Mult(stack) == Matrix(alloc, 1, k).GadgetVector(base)


@pytest.mark.parametrize("n,base", RINGS)
def test_g_lattice_samplers(n, base):
    """GaussSampGq and GaussSampGqArbBase on JAX's draws: the same [k, n]
    integers, and G z = u mod q."""
    jring, ring = rings(n)
    k = td.gadget_k(ring.q, base)
    rng = np.random.default_rng(3)
    u = rng.integers(0, ring.q, n, dtype=np.int64)
    stddev = (base + 1) * dgs.SIGMA
    for jfn, fn in ((jdgs.gauss_samp_gq, dgs.gauss_samp_gq),
                    (jdgs.gauss_samp_gq_arb_base,
                     dgs.gauss_samp_gq_arb_base)):
        rec = Recorder(k)
        want = jfn(u, stddev, k, ring.q, base, rec)
        draws = rec.replay()
        got = fn(torch.as_tensor(u), stddev, k, ring.q, base, draws)
        assert draws.exhausted()
        np.testing.assert_array_equal(got.numpy(), want)
        g = torch.tensor([base ** t for t in range(k)], dtype=torch.int64)
        assert torch.equal(((g[:, None] * got).sum(0) - torch.as_tensor(u))
                           % ring.q, torch.zeros(n, dtype=torch.int64))
    assert torch.equal(dgs.get_digits(torch.as_tensor(u), base, k),
                       torch.as_tensor(jdgs.get_digits(u, base, k)))


def test_zsample_f_and_2x2():
    """ZSampleF (a scalar covariance at n = 32, the JAX test's, and a
    full one at n = 16) and ZSampleSigma2x2 on JAX's draws."""
    rng = np.random.default_rng(5)
    f_data = np.zeros(32, complex)
    f_data[0] = 144.0
    cases = [(f_data, np.full(32, 3.0)),
             (rng.normal(0, 1, 16) * 20 + np.r_[5e3, np.zeros(15)],
              rng.normal(0, 30, 16))]
    for f, c in cases:
        rec = Recorder(len(f))
        want = jdgs.zsample_f(JField2n(f, "COEFFICIENT"),
                              JField2n(c, "COEFFICIENT"), rec)
        got = dgs.zsample_f(convert.field2n_from_numpy(f, device="cpu"),
                            convert.field2n_from_numpy(c, device="cpu"),
                            rec.replay())
        np.testing.assert_array_equal(got.numpy(), want)
    n = 16
    ev = lambda x: JField2n(x, "COEFFICIENT").SetFormat("EVALUATION")
    a, b, d = (ev(rng.normal(0, 5, n) + np.r_[s, np.zeros(n - 1)])
               for s in (4e4, 0.0, 4e4))
    c0, c1 = (JField2n(rng.normal(0, 40, n), "COEFFICIENT") for _ in "cc")
    rec = Recorder(7)
    want = jdgs.zsample_sigma_2x2(a, b, d, (c0, c1), rec)
    port = lambda x: convert.field2n_from_numpy(x.data, x.fmt, device="cpu")
    got = dgs.zsample_sigma_2x2(port(a), port(b), port(d),
                                (port(c0), port(c1)), rec.replay())
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dim", [5, 6])
def test_sample_mat(dim):
    """SampleMat (no caller in either package, but public) on a diagonally
    dominant dim x dim covariance of Field2n split as its recursion splits
    (A ceil(dim / 2) square): its dim_d == 2 (dim 5), >= 3 (dim 6) and,
    inside them, dim_d == 1 branches, on JAX's draws."""
    n = 8
    rng = np.random.default_rng(dim)
    ev = lambda x: JField2n(x, "COEFFICIENT").SetFormat("EVALUATION")
    sig = np.zeros((dim, dim, n), complex)
    for i in range(dim):
        for j in range(dim):
            sig[i, j] = rng.normal(0, 3, n)
        sig[i, i, 0] += 1e4
    sig = (sig + sig.transpose(1, 0, 2)) / 2
    jm = lambda rows, cols, r0, c0: _jax_matrix(
        [[ev(sig[r0 + r, c0 + c]) for c in range(cols)]
         for r in range(rows)], n)
    na = (dim + 1) // 2
    nd = dim - na
    jA, jB, jD = jm(na, na, 0, 0), jm(na, nd, 0, na), jm(nd, nd, na, na)
    centers = rng.normal(0, 50, (dim, 1, n))
    jC = _jax_matrix([[JField2n(centers[i, 0], "COEFFICIENT")]
                      for i in range(dim)], n)
    rec = Recorder(dim)
    want = jdgs.sample_mat(jA, jB, jD, jC, rec)
    port = lambda m: convert.matrix_from_numpy(
        np.stack([[m(r, c).data for c in range(m.cols)]
                  for r in range(m.rows)]), fmt=m(0, 0).fmt, device="cpu")
    draws = rec.replay()
    got = dgs.sample_mat(port(jA), port(jB), port(jD), port(jC), draws)
    assert draws.exhausted()
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_matrix(rows, n):
    m = JMatrix(lambda: JField2n.zeros(n, "EVALUATION"), len(rows),
                len(rows[0]))
    m.data = [list(r) for r in rows]
    return m


@pytest.mark.parametrize("n,base", RINGS)
def test_gauss_samp_preimage(n, base):
    """GaussSamp on JAX's A, T and u (carried by `convert`) and its draws:
    x word for word, A x == u, and ||x|| below the spectral bound's
    order; ZSampleSigmaP alone on the same draws gives JAX's p."""
    jring, ring = rings(n)
    k = td.gadget_k(ring.q, base)
    seed = np.random.default_rng(11)
    jA, jT = jtd.trapdoor_gen(jring, jdgs.SIGMA, base, rng=seed)
    ju = JRingPoly.uniform(jring, seed)
    rec = Recorder(n)
    jx = jtd.gauss_samp(n, k, jA, jT, ju, rec, base)
    A = convert.matrix_from_numpy(
        np.stack([[jA(0, c).data for c in range(k + 2)]]), ring.q,
        device="cpu")
    T = convert.trapdoor_from_numpy(
        np.stack([jT.m_r(0, i).data for i in range(k)]),
        np.stack([jT.m_e(0, i).data for i in range(k)]), ring.q,
        device="cpu")
    u = convert.ring_poly_from_numpy(ju.data, ring.q, device="cpu")
    draws = rec.replay()
    x = td.gauss_samp(n, k, A, T, u, draws, base)
    assert draws.exhausted()
    assert same_matrix(x, jx)
    assert td.verify_preimage(A, x, u) and jtd.verify_preimage(jA, jx, ju)
    assert not td.verify_preimage(A, x, u + 1)
    assert x.Norm() == jx.Norm() < 10 * dgs.spectral_bound(n, k, base)
    s, c = dgs.spectral_bound(n, k, base), (base + 1) * dgs.SIGMA
    rec = Recorder(1)
    jp = jtd.zsample_sigma_p(n, s, c, jT, rec)
    assert same_matrix(td.zsample_sigma_p(n, s, c, T, rec.replay()), jp)


def test_moduli_of_31_bits_or_more_are_refused():
    """The port's words are 31-bit: q >= 2^31 raises (JAX takes q < 2^32);
    the largest NTT-friendly q below 2^31 works."""
    from openfhe_tpu_torch.math import nbtheory
    n = 64
    big = nbtheory.next_prime(1 << 31, 2 * n)
    assert JRingParams.create(n, q=big).q == big
    with pytest.raises(ValueError, match="31-bit"):
        RingParams.create(n, q=big, device="cpu")
    top = nbtheory.previous_prime(1 << 31, 2 * n)
    ring = RingParams.create(n, q=top, device="cpu")
    p = RingPoly.from_coeffs(ring, np.arange(n))
    assert p.SetFormat("EVALUATION").SetFormat("COEFFICIENT") == p
