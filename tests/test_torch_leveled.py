"""The port's leveled CKKS layer against the JAX package, word for word.

Under FIXEDAUTO, FLEXIBLEAUTO, FLEXIBLEAUTOEXT and COMPOSITESCALINGAUTO,
one JAX context per technique (N=2^10, 2 digits, seed 21) makes the keys
and two fresh ciphertexts; `convert` carries them into the port's context
of the same parameters on the CPU. Every op of the leveled layer
(encoding at a level, degree and scale; EvalAdd / EvalSub / EvalMult with
ciphertext, plaintext and scalar operands; EvalNegate, EvalSquare,
EvalMultNoRelin, Relinearize, EvalMultAndRelinearize; operands at
different levels and degrees, which each technique aligns its own way;
ModReduce, LevelReduce, Compress, Decrypt) must give the JAX words with
equal `level`, `noise_deg` and `scale` (`==`: scales are Python floats in
the same order of operations). The JAX results are computed once per
technique. Noise-flooding decryption is checked statistically (the two
packages' RNGs never agree).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openfhe_tpu.pke import constants as jc  # noqa: E402
from openfhe_tpu.pke import context as jctx  # noqa: E402
from openfhe_tpu.pke import parameters as jprm  # noqa: E402

import openfhe_tpu_torch as fhe  # noqa: E402
from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch.math import crt  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32  # noqa: E402
from openfhe_tpu_torch.pke import constants as tc  # noqa: E402
from openfhe_tpu_torch.pke import parameters as prm  # noqa: E402
from openfhe_tpu_torch.pke.ciphertext import Plaintext  # noqa: E402

N = 1 << 10
# technique -> the parameters that differ (composite scaling: two towers a
# level, tests/test_composite_scaling.py's sizes)
TECHNIQUES = {
    "FIXEDAUTO": dict(mult_depth=3, scaling_mod_size=26, first_mod_size=27),
    "FLEXIBLEAUTO": dict(mult_depth=3, scaling_mod_size=26,
                         first_mod_size=27),
    "FLEXIBLEAUTOEXT": dict(mult_depth=3, scaling_mod_size=26,
                            first_mod_size=27),
    "COMPOSITESCALINGAUTO": dict(mult_depth=2, scaling_mod_size=50,
                                 first_mod_size=56),
}


def _kw(name):
    return dict(ring_dim=N, aux_mod_size=27, num_large_digits=2,
                **TECHNIQUES[name])


def _jax_ctx(name):
    p = jprm.CCParams(scheme=jc.Scheme.CKKSRNS_SCHEME,
                      security_level=jc.SecurityLevel.HEStd_NotSet,
                      scaling_technique=jc.ScalingTechnique[name],
                      **_kw(name))
    return jctx.GenCryptoContext(p, seed=21)


def _port_ctx(name):
    p = fhe.CCParams(scheme=fhe.Scheme.CKKSRNS_SCHEME,
                     security_level=fhe.SecurityLevel.HEStd_NotSet,
                     scaling_technique=fhe.ScalingTechnique[name],
                     **_kw(name))
    return fhe.GenCryptoContext(p, seed=21, device="cpu")


# Each op takes the context and the inputs of its own package: x, y fresh
# ciphertexts, prod = EvalMult(x, y) (degree 2 under the AUTO modes), resc
# = ModReduce(prod), sq = EvalMult(resc, resc) (one level down, degree 2),
# z, w the slot vectors and pt_z a plaintext of z at level 1.
OPS = {
    "encode": lambda cc, i: cc.MakeCKKSPackedPlaintext(i["z"]),
    "encode_level1_deg2": lambda cc, i: cc.MakeCKKSPackedPlaintext(
        i["z"], scale_deg=2, level=1),
    "encode_at_scale": lambda cc, i: cc.MakeCKKSPackedPlaintext(
        i["z"], level=1, scale=3.0 * 2.0 ** 20),
    "add": lambda cc, i: cc.EvalAdd(i["x"], i["y"]),
    "sub": lambda cc, i: cc.EvalSub(i["x"], i["y"]),
    "negate": lambda cc, i: cc.EvalNegate(i["x"]),
    "add_scalar": lambda cc, i: cc.EvalAdd(i["x"], 0.75),
    "sub_scalar_deg2": lambda cc, i: cc.EvalSub(i["prod"], -1.25),
    "add_plain_deg2": lambda cc, i: cc.EvalAdd(i["prod"], i["pt_z"]),
    "sub_plain": lambda cc, i: cc.EvalSub(i["x"], i["pt_z"]),
    "mult_scalar": lambda cc, i: cc.EvalMult(i["x"], 0.5),
    "mult_scalar_deg2": lambda cc, i: cc.EvalMult(i["prod"], -2.5),
    "mult_plain": lambda cc, i: cc.EvalMult(
        i["x"], cc.MakeCKKSPackedPlaintext(i["w"])),
    "mult": lambda cc, i: i["prod"],
    "rescale": lambda cc, i: i["resc"],
    "square": lambda cc, i: cc.EvalSquare(i["prod"]),
    "mult_no_relin": lambda cc, i: cc.EvalMultNoRelin(i["x"], i["y"]),
    "relinearize": lambda cc, i: cc.Relinearize(
        cc.EvalMultNoRelin(i["resc"], i["y"])),
    "mult_and_relinearize": lambda cc, i: cc.EvalMultAndRelinearize(
        i["resc"], i["x"]),
    "add_deg2_level1_to_level0": lambda cc, i: cc.EvalAdd(i["sq"], i["x"]),
    "add_level0_to_deg2_level1": lambda cc, i: cc.EvalAdd(i["x"], i["sq"]),
    "sub_levels": lambda cc, i: cc.EvalSub(i["resc"], i["prod"]),
    "sub_three_elements": lambda cc, i: cc.EvalSub(
        i["x"], cc.EvalMultNoRelin(i["x"], i["y"])),
    "mult_levels": lambda cc, i: cc.EvalMult(i["sq"], i["x"]),
    "rescale_two_levels": lambda cc, i: cc.ModReduce(i["sq"], 2)
    if len(cc.moduli_q) - cc.comp_deg * 3 > 0 else cc.ModReduce(i["sq"]),
    "level_reduce": lambda cc, i: cc.LevelReduce(i["x"], 2),
    "compress": lambda cc, i: cc.Compress(i["prod"], 2),
}


def _inputs(cc, x, y, z, w):
    prod = cc.EvalMult(x, y)
    resc = cc.ModReduce(prod)
    return dict(x=x, y=y, z=z, w=w, prod=prod, resc=resc,
                sq=cc.EvalMult(resc, resc),
                pt_z=cc.MakeCKKSPackedPlaintext(z, level=1))


@functools.lru_cache(maxsize=None)
def _sides(name):
    """Both packages' contexts of one technique, the JAX results of its
    ops, and the port's inputs made from the JAX-made ciphertexts; built
    once per technique (a module fixture that tests re-parametrise is
    torn down and built again as their parameters alternate)."""
    jcc = _jax_ctx(name)
    jcc.Enable(jc.PKESchemeFeature.PKE | jc.PKESchemeFeature.KEYSWITCH
               | jc.PKESchemeFeature.LEVELEDSHE)
    kp = jcc.KeyGen()
    jcc.EvalMultKeyGen(kp.secret_key)
    rng = np.random.default_rng(len(name))
    z = rng.uniform(-0.5, 0.5, jcc.slots)
    w = rng.uniform(-0.5, 0.5, jcc.slots)
    jx = jcc.Encrypt(kp.public_key, jcc.MakeCKKSPackedPlaintext(z))
    jy = jcc.Encrypt(kp.public_key, jcc.MakeCKKSPackedPlaintext(w))
    jin = _inputs(jcc, jx, jy, z, w)
    want = {op: fn(jcc, jin) for op, fn in OPS.items()}
    sq = jin["sq"]
    want_dec = jctx._k_decrypt(tuple(sq.elements), kp.secret_key,
                               jcc.basis_at(sq.level))
    want_vals = jcc.Decrypt(kp.secret_key, sq).values

    cc = _port_ctx(name)
    tag = kp.secret_key.key_tag
    jek = jcc.eval_mult_keys[tag]
    cc.eval_mult_keys[tag] = convert.eval_key_from_numpy(
        np.asarray(jek.bv), np.asarray(jek.av), key_tag=tag, device="cpu",
        bv_sh=np.asarray(jek.bv_sh), av_sh=np.asarray(jek.av_sh))
    sk = convert.private_key_from_numpy(np.asarray(kp.secret_key.s_qp),
                                        key_tag=tag, device="cpu")
    port_in = _inputs(cc, _ct(jx), _ct(jy), z, w)
    return dict(name=name, jcc=jcc, cc=cc, sk=sk, jsk=kp.secret_key,
                want=want,
                port_in=port_in, want_dec=np.asarray(want_dec),
                want_vals=want_vals, z=z, w=w)


@pytest.fixture(scope="module", params=list(TECHNIQUES))
def sides(request):
    return _sides(request.param)


def _ct(jct):
    return convert.ciphertext_from_numpy(
        [np.asarray(e) for e in jct.elements], level=jct.level,
        noise_deg=jct.noise_deg, scale=jct.scale, slots=jct.slots,
        key_tag=jct.key_tag, device="cpu")


def _assert_same(got, want):
    if isinstance(want, jctx.Plaintext):
        assert isinstance(got, Plaintext)
        np.testing.assert_array_equal(to_u32(got.poly), np.asarray(want.poly))
    else:
        assert len(got.elements) == len(want.elements)
        for g, w in zip(got.elements, want.elements):
            np.testing.assert_array_equal(to_u32(g), np.asarray(w))
    assert (got.level, got.noise_deg, got.slots) == (want.level,
                                                     want.noise_deg,
                                                     want.slots)
    assert got.scale == want.scale


def test_moduli_and_scales_match_jax(sides):
    cc, jcc = sides["cc"], sides["jcc"]
    assert cc.moduli_q == list(jcc.moduli_q)
    assert cc.moduli_p == list(jcc.moduli_p)
    assert cc.comp_deg == jcc.comp_deg
    assert cc.scf_real == jcc.scf_real
    assert [cc.scale_at(l) for l in range(len(cc.scf_real))] == [
        jcc.scale_at(l) for l in range(len(jcc.scf_real))]
    assert [cc.drop_factor(l) for l in range(len(cc.scf_real))] == [
        jcc.drop_factor(l) for l in range(len(jcc.scf_real))]
    assert [cc.size_ql(l) for l in range(len(cc.scf_real))] == [
        jcc.size_ql(l) for l in range(len(jcc.scf_real))]
    assert cc.GetModulus() == jcc.GetModulus()
    assert cc.GetRootOfUnity() == jcc.GetRootOfUnity()
    sizes = [cc.size_ql(l) for l in range(len(cc.scf_real))]
    assert len(set(sizes)) == len(sizes) and min(sizes) >= 1


@pytest.mark.parametrize("name,op", [(name, op) for name in TECHNIQUES
                                     for op in OPS])
def test_op_matches_jax(name, op):
    sides = _sides(name)
    got = OPS[op](sides["cc"], sides["port_in"])
    _assert_same(got, sides["want"][op])


def test_decrypt_matches_jax(sides):
    cc, sk = sides["cc"], sides["sk"]
    sq = sides["port_in"]["sq"]
    dec = cc.Decrypt(sk, sq)
    np.testing.assert_array_equal(to_u32(dec.poly), sides["want_dec"])
    np.testing.assert_allclose(dec.values, sides["want_vals"], rtol=0,
                               atol=1e-9)
    want = (sides["z"] * sides["w"]) ** 2
    assert np.abs(dec.values.real - want).max() < 1e-3


def test_noise_estimation_log_error_matches_jax(sides):
    """EXEC_NOISE_ESTIMATION: log2 of the largest imaginary part times
    the scale, from the same words on both sides."""
    cc, jcc = sides["cc"], sides["jcc"]
    jct = sides["want"]["mult_levels"]
    mode = tc.ExecutionMode.EXEC_NOISE_ESTIMATION
    cc.params.execution_mode = mode
    jcc.params.execution_mode = jc.ExecutionMode.EXEC_NOISE_ESTIMATION
    try:
        got = cc.Decrypt(sides["sk"], _ct(jct))
        want = jcc.Decrypt(sides["jsk"], jct)
    finally:
        cc.params.execution_mode = tc.ExecutionMode.EXEC_EVALUATION
        jcc.params.execution_mode = jc.ExecutionMode.EXEC_EVALUATION
    assert got.GetLogError() == want.GetLogError() > 0


@pytest.mark.parametrize("sides", ["FLEXIBLEAUTO"], indirect=True)
@pytest.mark.parametrize("log_sigma", [20, 30])
def test_noise_flooding_statistics(sides, log_sigma):
    """NOISE_FLOODING_DECRYPT adds a Gaussian of sigma 2^noise_estimate to
    every coefficient, sampled in int64: at 2^30 the +-6 sigma clip passes
    2^31 and nothing wraps."""
    cc, sk = sides["cc"], sides["sk"]
    x = sides["port_in"]["x"]
    moduli = tuple(cc.moduli_q[:x.num_towers])
    clean = cc.Decrypt(sk, x)
    p = cc.params
    saved = (p.decryption_noise_mode, p.noise_estimate)
    p.decryption_noise_mode = tc.DecryptionNoiseMode.NOISE_FLOODING_DECRYPT
    p.noise_estimate = float(log_sigma)
    try:
        flooded = [cc.Decrypt(sk, x) for _ in range(4)]
    finally:
        p.decryption_noise_mode, p.noise_estimate = saved
    base = crt.interpolate_centered(to_u32(clean.poly), moduli)
    diff = np.concatenate([
        (crt.interpolate_centered(to_u32(f.poly), moduli) - base)
        .astype(np.float64) for f in flooded])
    sigma = 2.0 ** log_sigma
    assert abs(diff.mean()) < 4 * sigma / np.sqrt(diff.size)
    assert abs(diff.std() / sigma - 1.0) < 0.05
    assert np.abs(diff).max() <= np.ceil(6 * sigma)
    if log_sigma == 30:
        assert np.abs(diff).max() > 2.0 ** 31
    # a slot sums N coefficients: std sigma sqrt(N) / scale
    assert np.abs(flooded[0].values - clean.values).max() < (
        8 * sigma * np.sqrt(N) / x.scale)


def test_composite_manual_chain_matches_jax():
    """COMPOSITESCALINGMANUAL builds the composite chain too."""
    kw = dict(_kw("COMPOSITESCALINGAUTO"), mult_depth=3)
    p = fhe.CCParams(scheme=fhe.Scheme.CKKSRNS_SCHEME,
                     security_level=fhe.SecurityLevel.HEStd_NotSet,
                     scaling_technique=(
                         fhe.ScalingTechnique.COMPOSITESCALINGMANUAL), **kw)
    cc = fhe.GenCryptoContext(p, device="cpu")
    want = jprm.select_ckks_moduli_composite(N, 3, 50, 56, 2)
    assert cc.comp_deg == 2 and cc.moduli_q == want
    assert cc.moduli_q == prm.select_ckks_moduli_composite(N, 3, 50, 56, 2)
    assert not cc._auto() and cc._flexible()


def test_main_path_chains_match_jax():
    """The chains chip_smoke.py's phase 7 runs at N=2^16, against the JAX
    package's parameter selection (host only, no context)."""
    n = 1 << 16
    got = prm.select_ckks_moduli(n, 30, 26, 27)
    assert got == jprm.select_ckks_moduli(n, 30, 26, 27)
    assert prm.select_ckks_moduli_composite(n, 8, 50, 56, 2) == \
        jprm.select_ckks_moduli_composite(n, 8, 50, 56, 2)


@pytest.mark.parametrize("log_n", [12, 13, 16])
def test_ext_prime_where_jax_has_none(log_n):
    """FLEXIBLEAUTOEXT's top prime: the JAX package's (a 19-bit prime) up
    to N=2^12; from N=2^13 on there is none and the JAX package raises, so
    the port takes the first 20-bit prime = 1 mod 2N, a fault of the
    reference it does not copy."""
    n = 1 << log_n
    ext = prm.DEFAULT_EXTRA_MOD_SIZE
    got = prm.select_ckks_moduli(n, 10, 26, 27, ext_mod_size=ext)
    assert got[:-1] == prm.select_ckks_moduli(n, 10, 26, 27)
    assert (got[-1] - 1) % (2 * n) == 0 and got[-1] not in got[:-1]
    if log_n <= 12:
        assert got == jprm.select_ckks_moduli(n, 10, 26, 27,
                                              ext_mod_size=ext)
        assert got[-1].bit_length() == ext - 1
    else:
        with pytest.raises(RuntimeError, match="no 19-bit prime"):
            jprm.select_ckks_moduli(n, 10, 26, 27, ext_mod_size=ext)
        assert got[-1].bit_length() == ext


@pytest.mark.parametrize("sides", ["FIXEDAUTO"], indirect=True)
def test_api_aliases(sides):
    """The InPlace / Mutable / NoCheck forms are the functional ops."""
    cc, i = sides["cc"], sides["port_in"]
    C = fhe.CryptoContext
    assert C.EvalAddInPlace is C.EvalAdd and C.EvalSubMutable is C.EvalSub
    assert C.EvalMultNoCheck is C.EvalMult
    assert C.RescaleInPlace is C.ModReduce
    same = lambda a, b: all(torch.equal(u, v)
                            for u, v in zip(a.elements, b.elements))
    assert same(cc.EvalNegateInPlace(i["x"]), cc.EvalNegate(i["x"]))
    assert same(cc.EvalSquareMutable(i["resc"]), cc.EvalSquare(i["resc"]))
    assert cc.GetRingDimension() == N and cc.GetCyclotomicOrder() == 2 * N
    assert cc.GetEvalMultKeyVector(i["x"].key_tag) == [
        cc.eval_mult_keys[i["x"].key_tag]]
    assert cc.GetAllEvalMultKeys() is cc.eval_mult_keys
    assert cc.GetElementParams() is cc.basis_q
    assert cc.GetScheme() == fhe.Scheme.CKKSRNS_SCHEME
    cc.SetKeyGenLevel(1)
    assert cc.GetKeyGenLevel() == 1
    cc.SetKeyGenLevel(0)
    assert dataclasses.replace(i["x"]).level == 0
