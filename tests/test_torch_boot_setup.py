"""The bootstrap's host side against the JAX package: the setup's tables,
the exact CRT switch, `Basis.take`, the RLWE schemelet; and, in the port
alone, the plaintext cache, a second Setup and the key-store methods.

The setup tables (the Chebyshev seed, K, boosts, rotation lists, the
collapsed FFT's parameters, stage schedules and diagonals) of either
package come from its own numpy on `tests/test_bootstrap.py`'s contexts
(seed 11) for four level budgets; they must agree within 1e-12 (the same
numpy code gives equal floats). The schemelet runs on
`tests/test_schemelet.py`'s context (N=256, depth 4, seed 5): its
big-integer coefficient pairs must be equal Python ints, and its CKKS
conversions the JAX words. The encryption's samples (a, e) are fixed on
both sides by monkeypatching the samplers, since the two packages draw
different numbers from one seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from openfhe_tpu.lattice import basis as jbasis  # noqa: E402
from openfhe_tpu.lattice import rns_tools as jrt  # noqa: E402
from openfhe_tpu.math import sampling as jsampling  # noqa: E402
from openfhe_tpu.pke.fhe import ckks_bootstrap as jbt  # noqa: E402
from openfhe_tpu.pke.fhe import fft_transform as jfftt  # noqa: E402
from openfhe_tpu.pke.schemelet import SchemeletRLWEMP as JSL  # noqa: E402

from openfhe_tpu_torch.lattice import basis, rns_tools as rt  # noqa: E402
from openfhe_tpu_torch.math import sampling  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32, u32_tensor  # noqa: E402
from openfhe_tpu_torch.pke.fhe import ckks_bootstrap as bt  # noqa: E402
from openfhe_tpu_torch.pke.fhe import fft_transform as fftt  # noqa: E402
from openfhe_tpu_torch.pke.schemelet import SchemeletRLWEMP as SL  # noqa
from openfhe_tpu_torch.utils.precision import \
    calculate_approximation_error  # noqa: E402
from test_bootstrap import make_boot_ctx  # noqa: E402
from test_torch_bgv import carry_keys, jax_context, port_context  # noqa
from test_torch_bootstrap import BOOT, COMPOSITE, N, same  # noqa: E402

BOOT20 = dict(BOOT, ring_dim=N, mult_depth=20)
SCHEMELET = dict(scheme="CKKSRNS_SCHEME", ring_dim=256, mult_depth=4,
                 scaling_mod_size=28, first_mod_size=30, batch_size=64,
                 scaling_technique="FLEXIBLEAUTO")
VALS = np.array([5, -3, 17, 100, -120, 0, 1, 77] * 16)


def same_polys(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert [int(v) for v in g] == [int(v) for v in w]


# ---------------------------------------------------------------------------
# the setup's tables, Basis.take and the exact switch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,slots,budget", [
    (64, 32, (1, 1)), (256, 16, (2, 2)), (64, 32, (3, 2)),
    (256, 32, (2, 1))], ids=["dense", "staged22", "staged32", "mixed21"])
def test_setup_tables_match_jax(n, slots, budget):
    """The precompute of either package from its own numpy: equal
    Chebyshev seed, K, boosts, rotation lists, collapsed FFT parameters,
    stage schedules and diagonals within 1e-12."""
    jcc = make_boot_ctx(n, depth=20)
    jcc.EvalBootstrapSetup(level_budget=budget, slots=slots)
    cc = port_context(11, ring_dim=n, **dict(BOOT, mult_depth=20))
    cc.EvalBootstrapSetup(level_budget=budget, slots=slots)
    p, q = cc._boot_precom[slots], jcc._boot_precom[slots]
    for name in ("slots", "k_bound", "r_iters", "correction", "bstep_enc",
                 "bstep_dec", "pt_slots", "sparse", "runtime_scalar",
                 "boost1", "boost2"):
        assert getattr(p, name) == getattr(q, name), name
    np.testing.assert_allclose(p.cheb_coeffs, q.cheb_coeffs, rtol=0,
                               atol=1e-12)
    assert len(p.cheb_coeffs) == len(q.cheb_coeffs)
    assert bt.bootstrap_rotation_indices(cc, slots) == \
        jbt.bootstrap_rotation_indices(jcc, slots)
    assert cc.GetBootstrapDepth(budget) == jcc.GetBootstrapDepth(budget)
    for side in ("c2s", "s2c"):
        mine, theirs = getattr(p, side + "_diags"), getattr(q, side + "_diags")
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        mine, theirs = (getattr(p, side + "_stages"),
                        getattr(q, side + "_stages"))
        assert (mine is None) == (theirs is None)
        for a, b in zip(mine or [], theirs or []):
            assert (a.g, a.b, a.babies, a.giants) == (b.g, b.b, b.babies,
                                                      b.giants)
            assert a.diags.keys() == b.diags.keys()
            for u in a.diags:
                np.testing.assert_allclose(a.diags[u], b.diags[u], rtol=0,
                                           atol=1e-12)
        if mine:
            assert fftt.stage_rotation_indices(mine) == \
                jfftt.stage_rotation_indices(theirs)
    for log_slots in range(1, 16):
        for lb in range(1, log_slots + 1):
            assert fftt.select_layers(log_slots, lb) == \
                jfftt.select_layers(log_slots, lb)
    assert vars(fftt.get_collapsed_fft_params(slots, budget[0])) == \
        vars(jfftt.get_collapsed_fft_params(slots, budget[0]))


def test_basis_take_matches_jax():
    mods = tuple(port_context(11, ring_dim=N, **BOOT).moduli_q[:5])
    idx = (3, 0, 4)
    got = basis.make_basis(mods, 64).take(idx)
    want = jbasis.make_basis(mods, 64).take(idx)
    assert got.moduli == want.moduli == tuple(mods[i] for i in idx)
    for name in basis._TABLES:
        np.testing.assert_array_equal(to_u32(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
        assert getattr(got, name).is_contiguous()


def test_switch_crt_basis_exact_at_the_edges():
    """x = 0, B - 1, B/2, B/2 +- 1 and random words through the exact
    switch from the composite chain's first two towers to all of it: the
    JAX words, and x mod d_j up to the float32 estimate's one B."""
    mods = [m for m in port_context(4, **COMPOSITE).moduli_q]
    group, big_b = tuple(mods[:2]), mods[0] * mods[1]
    xs = [0, big_b - 1, big_b // 2, big_b // 2 - 1, big_b // 2 + 1]
    xs += [int(v) for v in np.random.default_rng(3).integers(
        0, big_b, 64 - len(xs), dtype=np.int64)]
    res = np.array([[v % b for v in xs] for b in group], np.uint32)
    b_in, b_out = basis.make_basis(group, 64), basis.make_basis(mods, 64)
    got = to_u32(rt.switch_crt_basis_exact(
        u32_tensor(res), b_in, b_out, rt.make_switch_tables(group, mods)))
    want = np.asarray(jrt.switch_crt_basis_exact(
        res, jbasis.make_basis(group, 64), jbasis.make_basis(mods, 64),
        jrt.make_switch_tables(group, mods)))
    np.testing.assert_array_equal(got, want)
    for j, d in enumerate(mods):
        for i, v in enumerate(xs):
            assert int(got[j, i]) in {v % d, (v - big_b) % d,
                                      (v + big_b) % d}
        # B/2 and its neighbours lie far from the estimate's edges
        assert [int(w) for w in got[j, 2:5]] == [v % d for v in xs[2:5]]



# ---------------------------------------------------------------------------
# the schemelet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def schemelet():
    jcc = jax_context(5, **SCHEMELET)
    kp = jcc.KeyGen()
    cc = port_context(5, **SCHEMELET)
    return dict(jcc=jcc, kp=kp, cc=cc, sk=carry_keys(jcc, cc, kp))


@pytest.mark.parametrize("big_q,level,bit_reverse", [
    (1 << 40, 0, False), (None, 2, True)], ids=["q40", "qprime-rev"])
def test_schemelet_encrypt_matches_jax(schemelet, monkeypatch, big_q, level,
                                       bit_reverse):
    """EncryptCoeff from the same samples a, e: equal coefficient pairs
    (at Q = 2^40 and at the level's own Q', bit-reversed), which both
    packages decrypt to the values."""
    jcc, cc = schemelet["jcc"], schemelet["cc"]
    size = len(cc.moduli_q) - level
    rng = np.random.default_rng(level)
    a = np.array([rng.integers(0, q, 256) for q in cc.moduli_q[:size]],
                 np.uint32)
    e = rng.integers(-19, 20, 256).astype(np.int32)
    monkeypatch.setattr(jsampling, "uniform_residues",
                        lambda key, b: jnp.asarray(a))
    monkeypatch.setattr(jsampling, "discrete_gaussian",
                        lambda key, shape: jnp.asarray(e))
    monkeypatch.setattr(sampling, "uniform_residues",
                        lambda gen, b: u32_tensor(a))
    monkeypatch.setattr(sampling, "discrete_gaussian",
                        lambda gen, shape: torch.from_numpy(e))
    q_prime = SL.get_q_prime(cc, level)
    assert q_prime == JSL.get_q_prime(jcc, level)
    big_q = big_q or q_prime
    got = SL.encrypt_coeff(cc, schemelet["sk"], VALS, big_q, 256,
                           level=level, bit_reverse=bit_reverse)
    want = JSL.encrypt_coeff(jcc, schemelet["kp"].secret_key, VALS, big_q,
                             256, level=level, bit_reverse=bit_reverse)
    same_polys(got, want)
    dec = SL.decrypt_coeff(cc, schemelet["sk"], got, big_q, 256,
                           level=level, bit_reverse=bit_reverse)
    np.testing.assert_array_equal(dec, VALS)


def test_schemelet_decrypt_and_mod_switch_match_jax(schemelet):
    """A JAX encryption: DecryptCoeff and ModSwitch give the JAX results
    and the values, before and after the switch."""
    jcc, cc, jsk = schemelet["jcc"], schemelet["cc"], schemelet["kp"]
    ct = JSL.encrypt_coeff(jcc, jsk.secret_key, VALS, 1 << 40, 256)
    sw, jsw = SL.mod_switch(ct, 1 << 30, 1 << 40), \
        JSL.mod_switch(ct, 1 << 30, 1 << 40)
    same_polys(sw, jsw)
    for polys, q in ((ct, 1 << 40), (sw, 1 << 30)):
        got = SL.decrypt_coeff(cc, schemelet["sk"], polys, q, 256)
        np.testing.assert_array_equal(
            got, JSL.decrypt_coeff(jcc, jsk.secret_key, polys, q, 256))
        np.testing.assert_array_equal(got, VALS)


def test_schemelet_ckks_conversion_matches_jax(schemelet):
    jcc, cc, jsk = schemelet["jcc"], schemelet["cc"], schemelet["kp"]
    vals = np.arange(-64, 64)
    ct = JSL.encrypt_coeff(jcc, jsk.secret_key, vals, 1 << 40, 256)
    ctk = SL.convert_rlwe_to_ckks(cc, ct, 1 << 40, slots=128)
    jctk = JSL.convert_rlwe_to_ckks(jcc, ct, 1 << 40, slots=128)
    same(ctk, jctk)
    assert ctk.key_tag == jctk.key_tag
    back = SL.convert_ckks_to_rlwe(cc, ctk, 1 << 40)
    same_polys(back, JSL.convert_ckks_to_rlwe(jcc, jctk, 1 << 40))
    np.testing.assert_array_equal(
        SL.decrypt_coeff(cc, schemelet["sk"], back, 1 << 40, 256), vals)


# ---------------------------------------------------------------------------
# the plaintext cache and the key stores (port only)
# ---------------------------------------------------------------------------

def test_cached_plaintext_is_per_context_and_per_array():
    """Two contexts of equal parameters keep their own encodings; one
    context returns its encoding for the same array and never one made
    for another array under the same id."""
    a, b = port_context(11, **BOOT20), port_context(11, **BOOT20)
    vals = np.linspace(-1, 1, 32) + 0.5j
    pa, pb = a._cached_plaintext(vals, 1, 32), b._cached_plaintext(vals, 1, 32)
    assert pa is not pb and a._pt_cache is not b._pt_cache
    np.testing.assert_array_equal(to_u32(pa.poly), to_u32(pb.poly))
    assert a._cached_plaintext(vals, 1, 32) is pa
    assert a._cached_plaintext(vals, 2, 32) is not pa
    other = vals * 2
    a._pt_cache[(id(other), 1, 32, 1)] = a._pt_cache[(id(vals), 1, 32, 1)]
    got = a._cached_plaintext(other, 1, 32)
    np.testing.assert_array_equal(
        to_u32(got.poly),
        to_u32(a.MakeCKKSPackedPlaintext(other, level=1, slots=32).poly))


def test_setup_again_with_another_budget_matches_a_fresh_context():
    """Setup, bootstrap, Setup again for the same slots with another level
    budget, bootstrap: the words of a fresh context set up once with the
    second budget, from the same keys and ciphertext."""
    cc = port_context(11, **BOOT20)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)
    x = np.random.default_rng(5).uniform(-1, 1, 32)
    ct = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(x, slots=32))
    cc.EvalBootstrapSetup(level_budget=(1, 1), slots=32)
    cc.EvalBootstrapKeyGen(kp.secret_key, 32)
    first = cc.EvalBootstrap(ct)
    first_encodings = len(cc._pt_cache)
    cc.EvalBootstrapSetup(level_budget=(2, 2), slots=32)
    assert len(cc._pt_cache) == 0 < first_encodings
    cc.EvalBootstrapKeyGen(kp.secret_key, 32)
    second = cc.EvalBootstrap(ct)
    fresh = port_context(11, **BOOT20)
    fresh.EvalBootstrapSetup(level_budget=(2, 2), slots=32)
    fresh.InsertEvalMultKey(cc.eval_mult_keys[kp.secret_key.key_tag])
    fresh.InsertEvalAutomorphismKey(
        cc.eval_automorphism_keys[kp.secret_key.key_tag],
        kp.secret_key.key_tag)
    same(second, fresh.EvalBootstrap(ct))
    assert second.level != first.level
    for out in (first, second):
        dec = cc.Decrypt(kp.secret_key, out).values
        assert calculate_approximation_error(dec, x) > 4.0


def test_key_store_methods():
    """EvalMultKeysGen, Insert*, Clear* (this context's stores only),
    SetPrivateKey / GetPrivateKey and JitPipeline."""
    cc, other = port_context(3, **SCHEMELET), port_context(3, **SCHEMELET)
    kp = cc.KeyGen()
    tag = kp.secret_key.key_tag
    cc.EvalMultKeysGen(kp.secret_key)
    cc.EvalSumKeyGen(kp.secret_key)
    cc.EvalConjugateKeyGen(kp.secret_key)
    ek, rot = cc.eval_mult_keys[tag], dict(cc.eval_automorphism_keys[tag])
    other.InsertEvalMultKey(ek)
    other.InsertEvalSumKey(rot, tag)
    assert other.GetEvalMultKeyVector(tag) == [ek]
    assert other.eval_automorphism_keys[tag] == rot
    other.ClearEvalMultKeys(tag)
    other.ClearEvalSumKeys()
    assert other.eval_mult_keys == {} and other.eval_automorphism_keys == {}
    assert cc.eval_mult_keys[tag] is ek and cc.eval_sum_keys == {tag: True}
    x = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(
        np.linspace(-1, 1, 64)))
    square = cc.JitPipeline(lambda c: cc.EvalMult(c, c))
    same(square(x), cc.EvalMult(x, x))
    assert cc.GetPrivateKey() is None
    cc.SetPrivateKey(kp.secret_key)
    assert cc.GetPrivateKey() is kp.secret_key
    cc.ClearEvalAutomorphismKeys(tag)
    assert tag not in cc.eval_automorphism_keys and tag in cc.eval_mult_keys
    cc.ClearStaticMapsAndVectors()
    assert (cc.eval_mult_keys, cc.eval_automorphism_keys,
            cc.eval_sum_keys) == ({}, {}, {})
    cc.SetCKKSBootCorrectionFactor(5)
    cc.EvalBootstrapSetup(slots=64)
    assert cc._boot_precom[64].correction == 5
    cc.EvalBootstrapPrecompute(slots=16)
    assert (cc._boot_precom[16].correction, cc._boot_precom[16].sparse) == (
        5, True)
