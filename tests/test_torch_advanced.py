"""The port's polynomial and Chebyshev evaluators against the JAX package.

`math/chebyshev.py` and `utils/precision.py` are copies: their results
must be bit-identical (`np.array_equal`, `==` on lists), since the
Paterson-Stockmeyer recursion branches on float tests of the
coefficients. The homomorphic evaluators run under FLEXIBLEAUTO on one
JAX context (N=2^10, depth 7, 2 digits, seed 13) that makes the keys and
the input ciphertexts, carried into the port's CPU context by `convert`;
the JAX results are computed once in a module fixture. Each op must give
the JAX words with equal `level`, `noise_deg` and `scale`.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openfhe_tpu.math import chebyshev as jcheb  # noqa: E402
from openfhe_tpu.pke import advanced as jadv  # noqa: E402
from openfhe_tpu.pke import constants as jc  # noqa: E402
from openfhe_tpu.pke import context as jctx  # noqa: E402
from openfhe_tpu.pke import parameters as jprm  # noqa: E402
from openfhe_tpu.utils import precision as jprec  # noqa: E402

import openfhe_tpu_torch as fhe  # noqa: E402
from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch.math import chebyshev as cheb  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32  # noqa: E402
from openfhe_tpu_torch.pke import advanced  # noqa: E402
from openfhe_tpu_torch.utils import precision  # noqa: E402

KW = dict(ring_dim=1 << 10, mult_depth=7, scaling_mod_size=26,
          first_mod_size=27, aux_mod_size=27, num_large_digits=2)
MERGE = 4
LOGISTIC = 13

FUNCS = {"sin": math.sin, "cos": math.cos, "logistic": advanced.logistic,
         "inverse": lambda x: 1.0 / x}


@pytest.mark.parametrize("func,a,b,degree", [
    ("sin", -1.0, 1.0, 32), ("logistic", -8.0, 8.0, 119),
    ("logistic", -1.0, 1.0, 13), ("cos", -2.0, 3.0, 9),
    ("inverse", 1.0, 2.0, 6)])
def test_chebyshev_coefficients_match_jax(func, a, b, degree):
    got = cheb.eval_chebyshev_coefficients(FUNCS[func], a, b, degree)
    want = jcheb.eval_chebyshev_coefficients(FUNCS[func], a, b, degree)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n,g", [(13, 4), (32, 8), (119, 64), (3, 5)])
def test_long_division_matches_jax(n, g):
    rng = np.random.default_rng(n)
    f = [complex(v) for v in rng.normal(size=n + 1)]
    f[n // 2] = 0.0
    tg = [0.0] * g + [1.0]
    got, want = cheb.long_division_chebyshev(f, tg), \
        jcheb.long_division_chebyshev(f, tg)
    assert got == want
    assert [cheb.ps_split_degree(d) for d in range(1, 130)] == [
        jcheb.ps_split_degree(d) for d in range(1, 130)]


def test_precision_matches_jax():
    rng = np.random.default_rng(2)
    want = rng.normal(size=64) + 1j * rng.normal(size=64)
    for err in (1e-3, 1e-9, 0.0):
        got = want + err * rng.normal(size=64)
        assert precision.calculate_approximation_error(got, want) == \
            jprec.calculate_approximation_error(got, want)
    with pytest.raises(ValueError):
        precision.calculate_approximation_error(want[:3], want)


def _merge_jax(cc, cts):
    """EvalMerge as the JAX package means it: its `eval_merge` hands the
    mask to EvalMult as a bare numpy array, which EvalMult does not take,
    so the mask is encoded at the ciphertext's level first."""
    mask0 = np.zeros(cts[0].slots)
    mask0[0] = 1.0
    acc = None
    for i, ct in enumerate(cts):
        masked = cc.EvalMult(ct, cc._encode_like_mult(ct, mask0))
        if i:
            masked = cc.EvalRotate(masked, -i)
        acc = masked if acc is None else cc.EvalAdd(acc, masked)
    return acc


POLY = [0.25, -0.5, 0.75, 0.125, -0.0625]
SERIES = [0.3, -0.2, 0.1, 0.05, 0.0, -0.025]
PS_SERIES = [0.5, 0.25, -0.125, 0.0625, 0.03125, -0.015625, 0.0,
             0.0078125, -0.00390625, 0.001953125]

# op -> fn(cc, x, y, zs): x, y fresh ciphertexts, zs a list of MERGE more
OPS = {
    "linear_wsum": lambda cc, x, y, zs: cc.EvalLinearWSum(
        [x, y, zs[0]], [0.5, -1.5, 2.0]),
    "merge": None,
    "powers_poly_with_precomp": lambda cc, x, y, zs: cc.EvalPolyWithPrecomp(
        cc.EvalPowers(x, POLY), POLY),
    "poly_linear": lambda cc, x, y, zs: cc.EvalPolyLinear(y, POLY[:4]),
    "poly": lambda cc, x, y, zs: cc.EvalPoly(x, [0.0, 1.0, 0.0, -0.5j]),
    "cheby_polys_series_with_precomp":
        lambda cc, x, y, zs: cc.EvalChebyshevSeriesWithPrecomp(
            cc.EvalChebyPolys(x, SERIES, -2.0, 2.0), SERIES),
    "chebyshev_series_linear": lambda cc, x, y, zs:
        cc.EvalChebyshevSeriesLinear(y, SERIES + [0.01, -0.005, 0.002],
                                     -1.0, 1.0),
    "chebyshev_series_ps": lambda cc, x, y, zs: cc.EvalChebyshevSeriesPS(
        x, PS_SERIES, -1.0, 1.0),
    "chebyshev_series": lambda cc, x, y, zs: cc.EvalChebyshevSeries(
        y, PS_SERIES + [0.0, 0.0009765625], -2.0, 2.0),
    "logistic": lambda cc, x, y, zs: cc.EvalLogistic(x, -4.0, 4.0,
                                                     LOGISTIC),
    "sin": lambda cc, x, y, zs: cc.EvalSin(y, -1.0, 1.0, 7),
    "cos_ps": lambda cc, x, y, zs: cc.EvalCos(x, -2.0, 3.0, 9),
    "divide": lambda cc, x, y, zs: cc.EvalDivide(zs[1], 1.0, 2.0, 6),
    "chebyshev_function": lambda cc, x, y, zs: cc.EvalChebyshevFunction(
        lambda v: v * v - 0.5, zs[2], -1.0, 1.0, 4),
}


@pytest.fixture(scope="module")
def sides():
    p = jprm.CCParams(scheme=jc.Scheme.CKKSRNS_SCHEME,
                      security_level=jc.SecurityLevel.HEStd_NotSet,
                      scaling_technique=jc.ScalingTechnique.FLEXIBLEAUTO,
                      **KW)
    jcc = jctx.GenCryptoContext(p, seed=13)
    jcc.Enable(jc.PKESchemeFeature.PKE | jc.PKESchemeFeature.KEYSWITCH
               | jc.PKESchemeFeature.LEVELEDSHE
               | jc.PKESchemeFeature.ADVANCEDSHE)
    kp = jcc.KeyGen()
    jcc.EvalMultKeyGen(kp.secret_key)
    jcc.EvalRotateKeyGen(kp.secret_key, [-i for i in range(1, MERGE)])
    rng = np.random.default_rng(13)
    vals = [rng.uniform(-0.9, 0.9, jcc.slots) for _ in range(2)]
    vals += [rng.uniform(1.05, 1.95, jcc.slots) if i == 1 else
             rng.uniform(-0.9, 0.9, jcc.slots) for i in range(MERGE)]
    jcts = [jcc.Encrypt(kp.public_key, jcc.MakeCKKSPackedPlaintext(v))
            for v in vals]
    jx, jy, jzs = jcts[0], jcts[1], jcts[2:]
    want = {op: (_merge_jax(jcc, jzs) if fn is None
                 else fn(jcc, jx, jy, jzs)) for op, fn in OPS.items()}
    dec = {op: jcc.Decrypt(kp.secret_key, ct).values
           for op, ct in want.items()}

    cc = fhe.GenCryptoContext(
        fhe.CCParams(scheme=fhe.Scheme.CKKSRNS_SCHEME,
                     security_level=fhe.SecurityLevel.HEStd_NotSet,
                     scaling_technique=fhe.ScalingTechnique.FLEXIBLEAUTO,
                     **KW), seed=13, device="cpu")
    tag = kp.secret_key.key_tag
    jek = jcc.eval_mult_keys[tag]
    cc.eval_mult_keys[tag] = convert.eval_key_from_numpy(
        np.asarray(jek.bv), np.asarray(jek.av), key_tag=tag, device="cpu",
        bv_sh=np.asarray(jek.bv_sh), av_sh=np.asarray(jek.av_sh))
    cc.InsertEvalAutomorphismKey(convert.eval_key_map_from_numpy(
        jcc.eval_automorphism_keys[tag], key_tag=tag, device="cpu"), tag)
    cts = [convert.ciphertext_from_numpy(
        [np.asarray(e) for e in c.elements], level=c.level,
        noise_deg=c.noise_deg, scale=c.scale, slots=c.slots, key_tag=tag,
        device="cpu") for c in jcts]
    return dict(cc=cc, cts=cts, vals=vals, want=want, dec=dec,
                jcc=jcc, jzs=jzs)


def _assert_same(got, want):
    assert len(got.elements) == len(want.elements)
    for g, w in zip(got.elements, want.elements):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    assert (got.level, got.noise_deg, got.slots) == (want.level,
                                                     want.noise_deg,
                                                     want.slots)
    assert got.scale == want.scale


@pytest.mark.parametrize("op", list(OPS))
def test_op_matches_jax(sides, op):
    cc, cts = sides["cc"], sides["cts"]
    x, y, zs = cts[0], cts[1], cts[2:]
    got = cc.EvalMerge(zs) if op == "merge" else OPS[op](cc, x, y, zs)
    _assert_same(got, sides["want"][op])


def test_results_decrypt_to_the_functions(sides):
    """The JAX results (equal to the port's words) decrypt to what each
    function computes, so the comparisons above hold working ops."""
    dec, (x, y, *zs) = sides["dec"], sides["vals"]
    close = lambda op, want, tol: np.abs(dec[op].real - want).max() < tol
    assert close("linear_wsum", 0.5 * x - 1.5 * y + 2.0 * zs[0], 1e-3)
    merged = np.zeros_like(x)
    merged[:MERGE] = [z[0] for z in zs]
    assert close("merge", merged, 1e-3)
    assert close("poly_linear", sum(c * y ** j
                                    for j, c in enumerate(POLY[:4])), 1e-3)
    assert close("logistic", 1.0 / (1.0 + np.exp(-x)), 1e-2)
    assert close("sin", np.sin(y), 1e-3)
    assert close("divide", 1.0 / zs[1], 1e-2)
    assert close("chebyshev_function", zs[2] ** 2 - 0.5, 1e-3)
    assert np.abs(dec["poly"] - (x - 0.5j * x ** 3)).max() < 1e-3


def test_eval_merge_of_the_jax_package_takes_no_array(sides):
    """The fault the port does not copy: the JAX package's eval_merge
    passes the numpy mask to EvalMult, which reads its `elements`."""
    with pytest.raises(AttributeError, match="elements"):
        jadv.eval_merge(sides["jcc"], sides["jzs"])
