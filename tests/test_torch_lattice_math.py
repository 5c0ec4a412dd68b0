"""The port's Field2n, DFT, Matrix, samplers and BLAKE2 PRNG against JAX.

On the CPU: `math/dftransform.py` and `lattice/field2n.py` (every method)
within 1e-12 relative of the JAX package's (two FFT libraries round
differently); `math/matrix.py` with numbers and Field2n (Strassen,
determinant, cofactor, gadget, stacks); `math/dgg.py`'s table and
rounding paths and DiscreteGaussianGenerator on JAX's recorded variates,
word for word; `math/dgg_generic.py` and `utils/prng.py` word for word
from one seeded engine; the registry's external-PRNG hook; the fault of
`examples/sampling.py` (its sampler names are strings), and the entry
points that refuse the CPU unless asked.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openfhe_tpu.lattice.field2n import Field2n as JField2n  # noqa: E402
from openfhe_tpu.math import dftransform as jdft  # noqa: E402
from openfhe_tpu.math import dgg as jdgg  # noqa: E402
from openfhe_tpu.math import dgg_generic as jgen  # noqa: E402
from openfhe_tpu.math.matrix import Matrix as JMatrix  # noqa: E402
from openfhe_tpu.utils import prng as jprng  # noqa: E402

from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch.lattice.field2n import Field2n  # noqa: E402
from openfhe_tpu_torch.math import dftransform as dft  # noqa: E402
from openfhe_tpu_torch.math import dgg  # noqa: E402
from openfhe_tpu_torch.math import dgg_generic as gen  # noqa: E402
from openfhe_tpu_torch.math.draws import ReplayDraws, torch_draws  # noqa
from openfhe_tpu_torch.math.matrix import Matrix  # noqa: E402
from openfhe_tpu_torch.utils import prng  # noqa: E402
from test_torch_trapdoor import Recorder  # noqa: E402

REL = 1e-12


def close(got, want) -> bool:
    """Within REL of the largest magnitude of `want`."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return bool(np.abs(got - want).max() <= REL * max(np.abs(want).max(),
                                                      1.0))


def test_dftransform_matches_jax():
    rng = np.random.default_rng(0)
    for n in (1, 2, 8, 64, 1024):
        x = rng.normal(size=n) + 1j * rng.normal(size=n)
        for fn, jfn in ((dft.forward_transform, jdft.forward_transform),
                        (dft.inverse_transform, jdft.inverse_transform),
                        (dft.fft_forward, jdft.fft_forward),
                        (dft.fft_inverse, jdft.fft_inverse)):
            assert close(fn(torch.as_tensor(x)), jfn(x)), (n, fn.__name__)
    y = rng.normal(size=32)
    assert close(dft.inverse_transform(dft.forward_transform(y)), y)


def test_field2n_methods_match_jax():
    """Every Field2n method on the same values, within 1e-12 relative."""
    rng = np.random.default_rng(1)
    n = 16
    a, b = rng.normal(size=n) * 7, rng.normal(size=n) * 3
    ja, jb = JField2n(a, "COEFFICIENT"), JField2n(b, "COEFFICIENT")
    pa = convert.field2n_from_numpy(a, "COEFFICIENT", device="cpu")
    pb = convert.field2n_from_numpy(b, "COEFFICIENT", device="cpu")
    jea, jeb = ja.SetFormat("EVALUATION"), jb.SetFormat("EVALUATION")
    pea, peb = pa.SetFormat("EVALUATION"), pb.SetFormat("EVALUATION")
    cases = [(pea, jea), (pea.SwitchFormat(), jea.SwitchFormat()),
             (pa + pb, ja + jb), (pa + 2.5, ja + 2.5), (pea + 2.5, jea + 2.5),
             (pa - pb, ja - jb), (pa - 1.5, ja - 1.5), (pea * peb, jea * jeb),
             (pea * 3.0, jea * 3.0), (2.0 * pea, 2.0 * jea),
             (pa.ScalarMult(-0.5), ja.ScalarMult(-0.5)),
             (pea.Inverse(), jea.Inverse()), (pa.ShiftRight(), ja.ShiftRight()),
             (-pa, -ja), (pea.AutomorphismTransform(5),
                          jea.AutomorphismTransform(5)),
             (pa.Transpose(), ja.Transpose()),
             (pea.Transpose(), jea.Transpose()),
             (pa.ExtractEven(), ja.ExtractEven()),
             (pa.ExtractOdd(), ja.ExtractOdd()),
             (pa.Permute(), ja.Permute()),
             (pa.Permute().InversePermute(), ja.Permute().InversePermute())]
    for i, (got, want) in enumerate(cases):
        assert got.fmt == want.fmt and close(got.data, want.data), i
    assert abs(pea.Norm() - jea.Norm()) <= REL * jea.Norm()
    assert (pa.size(), len(pa)) == (ja.size(), len(ja)) == (n, n)
    assert pea * pea.Inverse() == Field2n(np.ones(n), "EVALUATION",
                                          device="cpu")
    assert pa.Transpose().SetFormat("EVALUATION") == pea.Transpose()
    assert Field2n.from_int_vector(torch.arange(4)) == Field2n(
        np.arange(4.0), device="cpu")
    with pytest.raises(ValueError, match="EVALUATION"):
        pa * pb
    with pytest.raises(ValueError, match="odd"):
        pea.AutomorphismTransform(4)


def _num_matrix(cls, vals):
    m = cls(lambda: 0.0, *vals.shape)
    for r in range(vals.shape[0]):
        for c in range(vals.shape[1]):
            m.set(r, c, float(vals[r, c]))
    return m


def test_matrix_matches_jax():
    """Numbers: Mult, StrassenMult, Determinant, CofactorMatrix, Transpose,
    stacks, extraction, Norm, GadgetVector, Ones, Identity; Field2n: the
    determinant and cofactor matrix that SampleMat takes."""
    rng = np.random.default_rng(2)
    a, b = rng.integers(-5, 6, (8, 8)), rng.integers(-5, 6, (8, 8))
    pa, pb = _num_matrix(Matrix, a), _num_matrix(Matrix, b)
    ja, jb = _num_matrix(JMatrix, a), _num_matrix(JMatrix, b)
    same = lambda p, j: p.data == j.data
    assert same(pa.StrassenMult(pb), ja.StrassenMult(jb))
    assert pa.StrassenMult(pb) == pa.Mult(pb)
    assert same(pa * pb, ja * jb) and same(pa + pb, ja + jb)
    assert same(pa - pb, ja - jb) and same(pa * 3, ja * 3)
    small = _num_matrix(Matrix, a[:4, :4])
    jsmall = _num_matrix(JMatrix, a[:4, :4])
    assert small.Determinant() == jsmall.Determinant() == round(
        np.linalg.det(a[:4, :4]))
    assert same(small.CofactorMatrix(), jsmall.CofactorMatrix())
    assert same(pa.Transpose(), ja.Transpose())
    assert same(pa.VStack(pb), ja.VStack(jb))
    assert same(pa.HStack(pb), ja.HStack(jb))
    assert same(pa.ExtractRow(3), ja.ExtractRow(3))
    assert same(pa.ExtractRows(2, 5), ja.ExtractRows(2, 5))
    assert same(pa.ExtractCol(6), ja.ExtractCol(6))
    assert pa.Norm() == ja.Norm() == 5.0
    for base in (2, 32):
        assert same(Matrix(lambda: 0, 2, 8).GadgetVector(base),
                    JMatrix(lambda: 0, 2, 8).GadgetVector(base))
    assert same(Matrix(lambda: 0, 3, 3).Identity(),
                JMatrix(lambda: 0, 3, 3).Identity())
    assert same(Matrix(lambda: 0, 2, 3).Ones(), JMatrix(lambda: 0, 2, 3).Ones())
    # a 3 x 3 matrix of Field2n in EVALUATION
    n = 8
    vals = rng.normal(size=(3, 3, n)) + 5.0
    ev = lambda x: JField2n(x, "COEFFICIENT").SetFormat("EVALUATION")
    jm = JMatrix(lambda: JField2n.zeros(n), 3, 3)
    jm.data = [[ev(vals[r, c]) for c in range(3)] for r in range(3)]
    pm = convert.matrix_from_numpy(
        np.stack([[jm(r, c).data for c in range(3)] for r in range(3)]),
        device="cpu")
    assert close(pm.Determinant().data, jm.Determinant().data)
    for r in range(3):
        for c in range(3):
            assert close(pm.CofactorMatrix()(r, c).data,
                         jm.CofactorMatrix()(r, c).data)
    pm.SetFormat("COEFFICIENT")
    assert close(pm(1, 2).data, vals[1, 2])


@pytest.mark.parametrize("sigma", [0.0, 3.19, 40.0, float(1 << 22)])
def test_sample_integers_on_replayed_variates(sigma):
    """Both paths (the table up to sigma 64, then the rounding path: its
    affine step done by the port on JAX's standard normals) and sigma 0,
    on 2-d fractional centers, word for word; the boundary sigma 64 is
    the table's (`test_discrete_gaussian_generator`)."""
    rng = np.random.default_rng(int(sigma) + 3)
    centers = rng.normal(0, 50, (3, 97))
    rec = Recorder(7)
    want = jdgg.sample_integers(rec, centers, sigma)
    draws = rec.replay()
    got = dgg.sample_integers(torch.as_tensor(centers), sigma, draws)
    assert draws.exhausted() and len(rec.recorded) == (sigma > 0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_discrete_gaussian_generator():
    """Each method on JAX's variates, word for word; then the port's own
    generator on the CPU: mean and standard deviation of 2^16 samples at
    sigma 3.19 and 2^20, within 5 standard errors."""
    rec = Recorder(9)
    jg = jdgg.DiscreteGaussianGenerator(3.19, rng=rec)
    want = [jg.GenerateInteger(0.25), jg.GenerateInteger(1.5, 100.0),
            jg.GenerateIntegerKarney(2.75, 12.0), jg.GenerateIntVector(64),
            jg.GenerateVector(32, np.linspace(-3, 3, 32), 70.0),
            jg.GenerateVector(16, np.linspace(0, 1, 16), 64.0)]
    g = dgg.DiscreteGaussianGenerator(3.19, device="cpu")
    g.draws = rec.replay()
    got = [g.GenerateInteger(0.25), g.GenerateInteger(1.5, 100.0),
           g.GenerateIntegerKarney(2.75, 12.0), g.GenerateIntVector(64),
           g.GenerateVector(32, torch.as_tensor(np.linspace(-3, 3, 32)),
                            70.0),
           g.GenerateVector(16, torch.as_tensor(np.linspace(0, 1, 16)),
                            64.0)]
    for x, y in zip(got, want):
        np.testing.assert_array_equal(np.asarray(x), y)
    gen_cpu = torch.Generator().manual_seed(4)
    for sigma in (3.19, float(1 << 20)):
        s = dgg.DiscreteGaussianGenerator(sigma, generator=gen_cpu)
        x = s.GenerateVector(1 << 16, torch.full((1 << 16,), 0.5,
                                                 dtype=torch.float64))
        x = x.double()
        se = sigma / 2 ** 8
        assert abs(x.mean().item() - 0.5) < 5 * se
        assert abs(x.std().item() - sigma) < 5 * sigma / 2 ** 8.5


def _seeded(mod, seed=7):
    mod.set_prng_factory(lambda: mod.Blake2Engine(
        seed=np.arange(seed, seed + 64, dtype=np.uint8)))


def test_blake2_stream_and_generic_sampler_word_for_word():
    """One seed on both sides: the BLAKE2 words, then the generic sampler
    over Peikert and Knuth-Yao base samplers (their tables too) and a
    lone Knuth-Yao sampler, integer for integer."""
    a = prng.Blake2Engine(seed=np.arange(64, dtype=np.uint8), counter=3)
    b = jprng.Blake2Engine(seed=np.arange(64, dtype=np.uint8), counter=3)
    np.testing.assert_array_equal(a.random_uint32s(300),
                                  b.random_uint32s(300))
    outs = []
    for mod, g in ((prng, gen), (jprng, jgen)):
        _seeded(mod)
        try:
            bg = g.BitGenerator()
            pk = [g.BaseSampler(i / 4, 34.0, bg, g.PEIKERT) for i in range(4)]
            ky = [g.BaseSampler(i / 4, 12.0, bg, g.KNUTH_YAO)
                  for i in range(4)]
            res = {"tables": (pk[1].m_vals, ky[2].ddg)}
            for name, samplers in (("peikert", pk), ("ky", ky)):
                dg = g.DiscreteGaussianGeneratorGeneric(samplers,
                                                        samplers[0].b_std, 2,
                                                        16.0)
                res[name] = [dg.generate_integer(c, s) for c, s in (
                    (5.25, 300.0), (-3.5, 1000.0), (0.0, 40.0))
                    for _ in range(40)]
            res["lone"] = [ky[1].generate_integer() for _ in range(200)]
            res["bits"] = [bg.generate() for _ in range(100)]
            outs.append(res)
        finally:
            mod.set_prng_factory(None)
    port, jax = outs
    for key in ("peikert", "ky", "lone", "bits"):
        assert port[key] == jax[key], key
    for x, y in zip(port["tables"], jax["tables"]):
        np.testing.assert_array_equal(x, y)
    xs = np.array(port["peikert"][:40], float)
    assert abs(xs.mean() - 5.25) < 5 * 300 / 40 ** 0.5


def test_set_prng_factory_is_the_ports_own():
    """An engine installed in the port's registry serves the port's
    get_prng (and its samplers), not the JAX package's; None restores
    BLAKE2."""
    class Counting:
        def __init__(self):
            self.state = 0

        def __call__(self):
            self.state += 1
            return self.state

    prng.set_prng_factory(Counting)
    try:
        assert [prng.get_prng()() for _ in range(3)] == [1, 2, 3]
        assert not isinstance(jprng.get_prng(), Counting)
        bg = gen.BitGenerator()
        assert [bg.generate() for _ in range(32)] == [0] * 29 + [1, 0, 0]
    finally:
        prng.set_prng_factory(None)
    assert isinstance(prng.get_prng(), prng.Blake2Engine)


def test_sampling_example_reference_fault():
    """`examples/sampling.py` passes "PEIKERT" and "KNUTH_YAO" as b_type;
    the JAX BaseSampler compares with the int PEIKERT (1), so both lists
    are Knuth-Yao samplers (no Peikert table, m_vals) that sample the
    same integers from one seed. The port refuses a string."""
    samplers = {}
    for name in ("PEIKERT", "KNUTH_YAO"):
        _seeded(jprng)
        try:
            s = jgen.BaseSampler(0.0, 34, jgen.BitGenerator(), name)
            samplers[name] = (s, [s.generate_integer() for _ in range(50)])
        finally:
            jprng.set_prng_factory(None)
    (p, p_out), (k, k_out) = samplers["PEIKERT"], samplers["KNUTH_YAO"]
    assert not hasattr(p, "m_vals") and hasattr(p, "ddg")
    assert p_out == k_out
    for name in ("PEIKERT", "KNUTH_YAO", 2):
        with pytest.raises(ValueError, match="b_type"):
            gen.BaseSampler(0.0, 34, gen.BitGenerator(), name)
    assert hasattr(gen.BaseSampler(0.0, 34, gen.BitGenerator(),
                                   gen.PEIKERT), "m_vals")


def test_replay_refuses_another_order():
    draws = ReplayDraws([("random", np.zeros(3)), ("normal", np.ones(4))],
                        "cpu")
    with pytest.raises(ValueError, match="record 0 is random"):
        draws.normal(3)
    assert draws.random(3).dtype == torch.float64
    with pytest.raises(ValueError):
        draws.normal((2, 2))
    assert draws.normal(4).sum() == 4 and draws.exhausted()
    with pytest.raises(IndexError):
        draws.integers(0, 5, 1)


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    """Without a card, every new entry point raises unless given the CPU:
    RingParams.create, DiscreteGaussianGenerator, torch_draws, Field2n
    from values, the arbitrary-cyclotomic transforms, `convert`'s lattice
    functions and the examples' main."""
    import importlib
    from openfhe_tpu_torch.lattice.ringq import RingParams
    from openfhe_tpu_torch.math import cyclotomic as cy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = 134217781          # first_prime(28, 10)
    calls = {
        "RingParams.create": lambda: RingParams.create(64, 28),
        "DiscreteGaussianGenerator": lambda: dgg.DiscreteGaussianGenerator(),
        "torch_draws": torch_draws,
        "Field2n": lambda: Field2n(np.zeros(4)),
        "Field2n.zeros": lambda: Field2n.zeros(4),
        "bluestein_fft": lambda: cy.bluestein_fft([1] * 5, q, 4),
        "forward_transform_arb": lambda: cy.forward_transform_arb(
            [1, 2], q, 5),
        "inverse_transform_arb": lambda: cy.inverse_transform_arb(
            [1] * 4, q, 5),
        "multiply_arb": lambda: cy.multiply_arb([1], [2], q, 5),
        "ring_poly_from_numpy": lambda: convert.ring_poly_from_numpy(
            np.zeros(64), 12289),
        "field2n_from_numpy": lambda: convert.field2n_from_numpy(
            np.zeros(4)),
        "matrix_from_numpy": lambda: convert.matrix_from_numpy(
            np.zeros((1, 1, 4), complex)),
        "trapdoor_from_numpy": lambda: convert.trapdoor_from_numpy(
            np.zeros((2, 64)), np.zeros((2, 64)), 12289)}
    for name in ("simple_integers", "simple_real_numbers", "pre", "sampling",
                 "external_prng"):
        calls[name] = importlib.import_module(f"examples_torch.{name}").main
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert RingParams.create(64, 28, device="cpu").device.type == "cpu"
    assert cy.multiply_arb([1], [2], q, 5, device="cpu") == [2, 0, 0, 0]
