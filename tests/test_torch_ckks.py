"""The port's CKKS main path against the JAX package, word for word.

One JAX context (N=2^13, 4 Q + 2 P towers of 26/27 bits, 2 digits,
FIXEDMANUAL, seed 11) makes the keys and ciphertexts; `convert` carries
them into the port's context of the same parameters on the CPU. EvalMult
(tensor product + HYBRID relinearization), Rescale and Decrypt must give
the JAX words. Only the float steps (decode) are compared with a
tolerance. Keys and encryptions made by the port itself are checked by a
round trip, and its samplers statistically: the two packages' RNGs never
agree.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openfhe_tpu.pke import constants as jc  # noqa: E402
from openfhe_tpu.pke import context as jctx  # noqa: E402
from openfhe_tpu.pke import parameters as jprm  # noqa: E402
from openfhe_tpu.pke.keyswitch import hybrid as jhybrid  # noqa: E402

import openfhe_tpu_torch as fhe  # noqa: E402
from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch.math import sampling  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32, u32_tensor  # noqa: E402
from openfhe_tpu_torch.pke import parameters as prm  # noqa: E402
from openfhe_tpu_torch.pke.keyswitch import hybrid  # noqa: E402

KW = dict(ring_dim=1 << 13, mult_depth=3, scaling_mod_size=26,
          first_mod_size=27, aux_mod_size=27, num_large_digits=2)


def _words(t):
    return to_u32(t)


@pytest.fixture(scope="module")
def jax_side():
    p = jprm.CCParams(scheme=jc.Scheme.CKKSRNS_SCHEME,
                      security_level=jc.SecurityLevel.HEStd_NotSet,
                      scaling_technique=jc.ScalingTechnique.FIXEDMANUAL, **KW)
    cc = jctx.GenCryptoContext(p, seed=11)
    cc.Enable(jc.PKESchemeFeature.PKE | jc.PKESchemeFeature.KEYSWITCH
              | jc.PKESchemeFeature.LEVELEDSHE)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)
    rng = np.random.default_rng(5)
    z = rng.normal(size=cc.slots)
    w = rng.normal(size=cc.slots)
    pt_z, pt_w = cc.MakeCKKSPackedPlaintext(z), cc.MakeCKKSPackedPlaintext(w)
    a, b = cc.Encrypt(kp.public_key, pt_z), cc.Encrypt(kp.public_key, pt_w)
    prod = cc.EvalMult(a, b)
    resc = cc.Rescale(prod)
    return dict(cc=cc, kp=kp, z=z, w=w, pt=pt_z, a=a, b=b, prod=prod,
                resc=resc, dec=cc.Decrypt(kp.secret_key, resc))


def _port_params():
    return fhe.CCParams(scheme=fhe.Scheme.CKKSRNS_SCHEME,
                        security_level=fhe.SecurityLevel.HEStd_NotSet,
                        scaling_technique=fhe.ScalingTechnique.FIXEDMANUAL,
                        **KW)


@pytest.fixture(scope="module")
def port_side(jax_side):
    """The port's CPU context with the JAX-made eval key carried over."""
    cc = fhe.GenCryptoContext(_port_params(), seed=11, device="cpu")
    jek = jax_side["cc"].eval_mult_keys[jax_side["kp"].secret_key.key_tag]
    tag = jax_side["kp"].secret_key.key_tag
    cc.eval_mult_keys[tag] = convert.eval_key_from_numpy(
        np.asarray(jek.bv), np.asarray(jek.av), key_tag=tag, device="cpu",
        bv_sh=np.asarray(jek.bv_sh), av_sh=np.asarray(jek.av_sh))
    sk = convert.private_key_from_numpy(
        np.asarray(jax_side["kp"].secret_key.s_qp), key_tag=tag,
        device="cpu")
    return cc, sk


def _ct(jct):
    return convert.ciphertext_from_numpy(
        [np.asarray(e) for e in jct.elements], level=jct.level,
        noise_deg=jct.noise_deg, scale=jct.scale, slots=jct.slots,
        key_tag=jct.key_tag, device="cpu")


def _assert_ct_equal(got, want):
    assert len(got.elements) == len(want.elements)
    for g, w in zip(got.elements, want.elements):
        np.testing.assert_array_equal(_words(g), np.asarray(w))
    assert (got.level, got.noise_deg, got.slots) == (want.level,
                                                     want.noise_deg,
                                                     want.slots)
    assert got.scale == want.scale


def test_moduli_chains_match_jax(jax_side, port_side):
    cc, _ = port_side
    assert cc.moduli_q == list(jax_side["cc"].moduli_q)
    assert cc.moduli_p == list(jax_side["cc"].moduli_p)
    assert (len(cc.moduli_q), len(cc.moduli_p)) == (4, 2)
    # the main path's chain: N=2^16, depth 30, 2 digits -> 31 Q + 16 P
    mp = prm.main_path_params()
    n, depth = mp.ring_dim, mp.mult_depth
    assert (n, depth, mp.num_large_digits) == (1 << 16, 30, 2)
    q = prm.select_ckks_moduli(n, depth, 26, 27, flexible=False)
    p = prm.select_aux_moduli(n, q, 2, 27)
    assert q == jprm.select_ckks_moduli(n, depth, 26, 27, flexible=False)
    assert p == jprm.select_aux_moduli(n, q, 2, 27)
    assert (len(q), len(p)) == (31, 16)
    assert max(q + p) < 1 << 27
    log_qp = sum(np.log2(float(m)) for m in q + p)
    prm.validate_security(mp, n, log_qp)


@pytest.mark.parametrize("size_ql", [4, 3])
def test_hybrid_tables_match_jax(jax_side, port_side, size_ql):
    cc, _ = port_side
    jt = jax_side["cc"].hybrid_tables(size_ql)
    tt = cc.hybrid_tables(size_ql)
    assert len(tt.parts) == len(jt.parts)
    for tp, jp in zip(tt.parts, jt.parts):
        assert (tp.start, tp.end) == (jp.start, jp.end)
        assert tp.digit_basis.moduli == tuple(jp.digit_basis.moduli)
        assert tp.compl_basis.moduli == tuple(jp.compl_basis.moduli)
        for name in ("bhat_inv", "bhat_inv_sh"):
            np.testing.assert_array_equal(
                _words(getattr(tp.switch, name)),
                np.asarray(getattr(jp.switch, name)))
        for name in ("bhat_mod_d", "bhat_mod_d_sh"):
            np.testing.assert_array_equal(
                _words(getattr(tp.switch, name)),
                np.asarray(getattr(jp.switch, name))[:, :, 0])
    for name in ("pinv_modq", "pinv_modq_sh"):
        np.testing.assert_array_equal(_words(getattr(tt.moddown, name)),
                                      np.asarray(getattr(jt.moddown, name)))
    assert tt.basis_qlp.moduli == tuple(jt.basis_qlp.moduli)
    jr = jax_side["cc"].rescale_tables(size_ql)
    tr = cc.rescale_tables(size_ql)
    assert tr.ql_half == jr.ql_half
    for name in ("qlinv", "qlinv_sh", "ql_half_modqi", "ql_half_modqi_sh"):
        np.testing.assert_array_equal(_words(getattr(tr, name)),
                                      np.asarray(getattr(jr, name)))


@pytest.mark.parametrize("size_ql", [4, 3])
def test_keyswitch_core_matches_jax(jax_side, port_side, size_ql):
    """size_ql 3 gives uneven digits (2 + 1 towers)."""
    cc, _ = port_side
    jcc = jax_side["cc"]
    tag = jax_side["kp"].secret_key.key_tag
    mods = np.array(cc.moduli_q[:size_ql], np.uint64)[:, None]
    rng = np.random.default_rng(size_ql)
    c2 = (rng.integers(0, 1 << 62, size=(size_ql, cc.ring_dim),
                       dtype=np.uint64) % mods).astype(np.uint32)
    jtabs = jcc.hybrid_tables(size_ql)
    assert jtabs.fused is None
    want = jhybrid.keyswitch_core(jnp.asarray(c2), jcc.eval_mult_keys[tag],
                                  jtabs)
    got = hybrid.keyswitch_core(u32_tensor(c2), cc.eval_mult_keys[tag],
                                cc.hybrid_tables(size_ql))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_words(g), np.asarray(w))


def test_eval_mult_matches_jax(jax_side, port_side):
    cc, _ = port_side
    got = cc.EvalMult(_ct(jax_side["a"]), _ct(jax_side["b"]))
    _assert_ct_equal(got, jax_side["prod"])


def test_rescale_matches_jax(jax_side, port_side):
    cc, _ = port_side
    got = cc.Rescale(_ct(jax_side["prod"]))
    _assert_ct_equal(got, jax_side["resc"])


def test_decrypt_matches_jax(jax_side, port_side):
    cc, sk = port_side
    jcc, resc = jax_side["cc"], jax_side["resc"]
    want = jctx._k_decrypt(tuple(resc.elements), jax_side["kp"].secret_key,
                           jcc.basis_at(resc.level))
    dec = cc.Decrypt(sk, _ct(resc))
    np.testing.assert_array_equal(_words(dec.poly), np.asarray(want))
    np.testing.assert_allclose(dec.values, jax_side["dec"].values, rtol=0,
                               atol=1e-9)
    zw = jax_side["z"] * jax_side["w"]
    assert np.abs(dec.values.real - zw).max() < 1e-2


def test_encode_matches_jax(jax_side, port_side):
    cc, _ = port_side
    pt = cc.MakeCKKSPackedPlaintext(jax_side["z"])
    want = jax_side["pt"]
    np.testing.assert_array_equal(_words(pt.poly), np.asarray(want.poly))
    assert (pt.level, pt.noise_deg, pt.scale, pt.slots) == (
        want.level, want.noise_deg, want.scale, want.slots)


def test_port_round_trip():
    """Keys, encryptions and the whole op chain made by the port alone."""
    cc = fhe.GenCryptoContext(_port_params(), seed=3, device="cpu")
    cc.Enable(fhe.PKESchemeFeature.PKE | fhe.PKESchemeFeature.KEYSWITCH
              | fhe.PKESchemeFeature.LEVELEDSHE)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)
    z = np.random.default_rng(9).normal(size=cc.slots)
    ct = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(z))
    sq = cc.Rescale(cc.EvalMult(ct, ct))
    assert (sq.level, sq.noise_deg, sq.num_towers) == (1, 1, 3)
    dec = cc.Decrypt(kp.secret_key, sq)
    assert np.abs(dec.values.real - z * z).max() < 1e-2
    # secret-key encryption and EvalAdd on the same keys
    ct_sk = cc.Encrypt(kp.secret_key, cc.MakeCKKSPackedPlaintext(z))
    dec = cc.Decrypt(kp.secret_key, cc.EvalAdd(ct, ct_sk))
    assert np.abs(dec.values.real - 2 * z).max() < 1e-2


def test_eval_mult_no_relin_refuses_three_elements():
    """A 3-element operand raises NotImplementedError (the JAX package's
    EvalMultNoRelin reads two elements and drops c2 without a word)."""
    cc = fhe.GenCryptoContext(_port_params(), seed=5, device="cpu")
    kp = cc.KeyGen()
    z = np.random.default_rng(4).normal(size=cc.slots)
    ct = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(z))
    prod3 = cc.EvalMultNoRelin(ct, ct)
    assert len(prod3.elements) == 3
    for call in (lambda: cc.EvalMultNoRelin(prod3, ct),
                 lambda: cc.EvalMultNoRelin(ct, prod3),
                 lambda: cc.EvalMult(prod3, ct)):
        with pytest.raises(NotImplementedError,
                           match="EvalMultNoRelin of a 3-element"):
            call()


def test_sampling_statistics():
    gen = torch.Generator().manual_seed(0)
    cc = fhe.GenCryptoContext(_port_params(), seed=1, device="cpu")
    n = 1 << 16
    t = sampling.ternary(gen, (n,))
    assert t.dtype == torch.int32 and set(t.unique().tolist()) == {-1, 0, 1}
    assert abs(t.double().mean().item()) < 0.02
    sp = sampling.ternary(gen, (n,), hamming_weight=192)
    assert int((sp != 0).sum()) == 192 and sp.abs().max() == 1
    g = sampling.discrete_gaussian(gen, (n,))
    assert g.abs().max() <= 20 and abs(g.double().mean().item()) < 0.05
    assert abs(g.double().std().item() - sampling.DEFAULT_SIGMA) < 0.1
    u = sampling.uniform_residues(gen, cc.basis_q)
    assert u.shape == (4, cc.ring_dim) and u.dtype == torch.int32
    q = cc.basis_q.q.long()
    assert bool((u >= 0).all()) and bool((u.long() < q).all())
    mean = (u.double() / q.double()).mean(dim=1)
    assert bool(((mean - 0.5).abs() < 0.02).all())
    r = sampling.to_residues(torch.tensor([-3, 0, 5], dtype=torch.int32),
                             cc.basis_q)
    assert r[:, 0].tolist() == [m - 3 for m in cc.moduli_q]
    assert r[:, 2].tolist() == [5] * 4


def test_context_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fhe.GenCryptoContext(_port_params())


def test_convert_without_device_needs_a_gpu(jax_side):
    """The conversions default to the GPU, as the context does."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    jct = jax_side["a"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.ciphertext_from_numpy([np.asarray(e) for e in jct.elements])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.private_key_from_numpy(
            np.asarray(jax_side["kp"].secret_key.s_qp))


@pytest.mark.parametrize("option", [
    dict(scheme=fhe.Scheme.BGVRNS_SCHEME, plaintext_modulus=65537),
    dict(scheme=fhe.Scheme.BFVRNS_SCHEME, plaintext_modulus=65537),
    dict(ks_technique=fhe.KeySwitchTechnique.BV),
    dict(scheme=fhe.Scheme.BGVRNS_SCHEME, plaintext_modulus=65537,
         multiparty_mode=fhe.pke.constants.MultipartyMode
         .NOISE_FLOODING_MULTIPARTY)])
def test_unported_options_raise(option):
    """BGV, BFV and BV key switching are ported
    (tests/test_torch_bgv.py, test_torch_bfv.py, test_torch_bv.py): each
    builds its context on the CPU with its scheme and key-switch
    technique. Multiparty is not: NOISE_FLOODING_MULTIPARTY, which changes
    the integer schemes' chains, still raises."""
    p = dataclasses.replace(_port_params(), **option)
    if "multiparty_mode" in option:
        with pytest.raises(NotImplementedError):
            fhe.GenCryptoContext(p, device="cpu")
        return
    cc = fhe.GenCryptoContext(p, device="cpu")
    assert cc.GetScheme() == p.scheme
    assert cc.params.ks_technique == p.ks_technique
    if p.ks_technique == fhe.KeySwitchTechnique.BV:
        assert cc.moduli_p == [] and cc.basis_qp is cc.basis_q
    else:
        assert len(cc.moduli_p) > 0
