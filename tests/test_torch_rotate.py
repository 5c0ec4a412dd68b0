"""The port's rotations and general key switches against the JAX package.

One JAX context (N=2^13, 4 Q + 2 P towers of 26/27 bits, 2 digits,
FIXEDMANUAL, seed 11: the parameters of tests/test_torch_ckks.py) makes
the keys (relinearization, rotations by 1, -1, 2 and the EvalSum ladder of
batch 8, conjugation, and a switch to a second secret) and the
ciphertexts; `convert` carries them into the port's CPU context. Every op
must give the JAX words: EvalRotate, EvalConjugate, Relinearize,
KeySwitch, EvalFastRotation and EvalSum, at level 0 and, for a rotation,
at level 1 (digits of 2 + 1 towers). A second CPU context with the fused
chain's tables attached runs `ks_fused.keyswitch_core_fused` (the plain
twins of the CUDA kernels) and must give the unfused chain's words.
EvalFastRotation is held against JAX's hoisted rotation, not against
EvalRotate: the approximate mod-up of a rotated polynomial and the
rotation of a mod-up differ by multiples of Q_j, so the two need not be
word-equal (both decrypt to the rotated message).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openfhe_tpu.lattice import automorph as jauto  # noqa: E402
from openfhe_tpu.pke import constants as jc  # noqa: E402
from openfhe_tpu.pke import context as jctx  # noqa: E402
from openfhe_tpu.pke import parameters as jprm  # noqa: E402

import openfhe_tpu_torch as fhe  # noqa: E402
from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch.lattice import automorph  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32  # noqa: E402
from openfhe_tpu_torch.pke.keyswitch import ks_fused  # noqa: E402

KW = dict(ring_dim=1 << 13, mult_depth=3, scaling_mod_size=26,
          first_mod_size=27, aux_mod_size=27, num_large_digits=2)
ROTATIONS = (1, -1, 2)
BATCH = 8
OPS = ("rotate+1", "rotate-1", "rotate+2", "conjugate", "relinearize",
       "keyswitch", "fast_rotation", "eval_sum", "rotate_level1",
       "inner_product")


def _run(cc, ct, ct_b, resc, op, switch_key):
    """One op of either package's context (the same method names)."""
    if op.startswith("rotate+") or op.startswith("rotate-"):
        return cc.EvalRotate(ct, int(op[len("rotate"):]))
    if op == "conjugate":
        return cc.EvalConjugate(ct)
    if op == "relinearize":
        return cc.Relinearize(cc.EvalMultNoRelin(ct, ct_b))
    if op == "keyswitch":
        return cc.KeySwitch(ct, switch_key)
    if op == "fast_rotation":
        digits = cc.EvalFastRotationPrecompute(ct)
        return cc.EvalFastRotation(ct, 1, 0, digits)
    if op == "eval_sum":
        return cc.EvalSum(ct, BATCH)
    if op == "rotate_level1":
        return cc.EvalRotate(resc, 1)
    assert op == "inner_product"
    return cc.EvalInnerProduct(ct, ct_b, BATCH)


@pytest.fixture(scope="module")
def jax_side():
    p = jprm.CCParams(scheme=jc.Scheme.CKKSRNS_SCHEME,
                      security_level=jc.SecurityLevel.HEStd_NotSet,
                      scaling_technique=jc.ScalingTechnique.FIXEDMANUAL, **KW)
    cc = jctx.GenCryptoContext(p, seed=11)
    cc.Enable(jc.PKESchemeFeature.PKE | jc.PKESchemeFeature.KEYSWITCH
              | jc.PKESchemeFeature.LEVELEDSHE
              | jc.PKESchemeFeature.ADVANCEDSHE)
    kp, kp2 = cc.KeyGen(), cc.KeyGen()
    sk = kp.secret_key
    cc.EvalMultKeyGen(sk)
    cc.EvalRotateKeyGen(sk, list(ROTATIONS))
    cc.EvalSumKeyGen(sk, BATCH)
    cc.EvalConjugateKeyGen(sk)
    switch_key = cc.KeySwitchGen(sk, kp2.secret_key)
    rng = np.random.default_rng(5)
    a, b = (cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(
        rng.normal(size=cc.slots))) for _ in range(2))
    resc = cc.Rescale(cc.EvalMult(a, b))
    want = {op: _run(cc, a, b, resc, op, switch_key) for op in OPS}
    return dict(cc=cc, sk=sk, a=a, b=b, resc=resc, want=want,
                switch_key=switch_key)


def _ct(jct):
    return convert.ciphertext_from_numpy(
        [np.asarray(e) for e in jct.elements], level=jct.level,
        noise_deg=jct.noise_deg, scale=jct.scale, slots=jct.slots,
        key_tag=jct.key_tag, device="cpu")


def _port_params():
    return fhe.CCParams(scheme=fhe.Scheme.CKKSRNS_SCHEME,
                        security_level=fhe.SecurityLevel.HEStd_NotSet,
                        scaling_technique=fhe.ScalingTechnique.FIXEDMANUAL,
                        **KW)


def _port_context(jax_side, fused: bool):
    """A CPU context holding the JAX-made keys; with `fused`, every
    level's tables carry the fused chain's tables."""
    jcc, tag = jax_side["cc"], jax_side["sk"].key_tag
    cc = fhe.GenCryptoContext(_port_params(), seed=11, device="cpu")
    jek = jcc.eval_mult_keys[tag]
    cc.eval_mult_keys[tag] = convert.eval_key_from_numpy(
        np.asarray(jek.bv), np.asarray(jek.av), key_tag=tag, device="cpu",
        bv_sh=np.asarray(jek.bv_sh), av_sh=np.asarray(jek.av_sh))
    cc.InsertEvalAutomorphismKey(convert.eval_key_map_from_numpy(
        jcc.eval_automorphism_keys[tag], device="cpu"), tag)
    if fused:
        kq = len(cc.moduli_q)
        for size in (kq, kq - 1):
            tabs = cc.hybrid_tables(size)
            cc._hybrid_cache[size] = dataclasses.replace(
                tabs, fused=ks_fused.make_fused_ks_tables(
                    tabs.basis_qlp, size, kq, KW["num_large_digits"]))
    return cc


@pytest.fixture(scope="module")
def port_side(jax_side):
    jsw = jax_side["switch_key"]
    switch_key = convert.eval_key_from_numpy(
        np.asarray(jsw.bv), np.asarray(jsw.av), key_tag=jsw.key_tag,
        device="cpu", bv_sh=np.asarray(jsw.bv_sh),
        av_sh=np.asarray(jsw.av_sh))
    ins = [_ct(jax_side[k]) for k in ("a", "b", "resc")]
    return dict(unfused=_port_context(jax_side, False),
                fused=_port_context(jax_side, True), ins=ins,
                switch_key=switch_key)


def _assert_same(got, want_elems):
    assert len(got.elements) == len(want_elems)
    for g, w in zip(got.elements, want_elems):
        np.testing.assert_array_equal(to_u32(g), w)


@pytest.mark.parametrize("op", OPS)
def test_op_matches_jax(jax_side, port_side, op):
    cc = port_side["unfused"]
    got = _run(cc, *port_side["ins"], op, port_side["switch_key"])
    want = jax_side["want"][op]
    _assert_same(got, [np.asarray(e) for e in want.elements])
    assert (got.level, got.noise_deg, got.slots, got.key_tag) == (
        want.level, want.noise_deg, want.slots, want.key_tag)
    assert got.scale == want.scale


@pytest.mark.parametrize("op", [o for o in OPS if o != "fast_rotation"])
def test_fused_dispatch_matches_unfused(port_side, op):
    """The fused key switch (tables attached on the CPU) gives the
    unfused chain's words through the context's public ops."""
    assert port_side["fused"].hybrid_tables(4).fused is not None
    got, want = (_run(port_side[k], *port_side["ins"], op,
                      port_side["switch_key"])
                 for k in ("fused", "unfused"))
    _assert_same(got, [to_u32(e) for e in want.elements])


@pytest.mark.parametrize("n", [1 << 10, 1 << 13])
def test_automorph_tables_match_jax(n):
    gs = [automorph.rotation_automorphism_index(r, n)
          for r in (1, -1, 2, -7, n // 4 - 1)] + [
              automorph.conjugation_index(n)]
    for r in (1, -1, 2, -7, n // 4 - 1):
        assert (automorph.rotation_automorphism_index(r, n)
                == jauto.rotation_automorphism_index(r, n))
    assert automorph.conjugation_index(n) == jauto.conjugation_index(n)
    for g in gs:
        np.testing.assert_array_equal(automorph.eval_indices(n, g),
                                      jauto.eval_indices(n, g))
        for got, want in zip(automorph.coeff_indices(n, g),
                             jauto.coeff_indices(n, g)):
            np.testing.assert_array_equal(got, want)


def test_port_rotation_round_trip():
    """Rotation and conjugation keys made by the port alone: the
    decryption of a rotated ciphertext is the rotated decryption. The
    key switch adds noise: at these parameters (digits as large as P,
    26-bit scale) its slot error is about 1e-2 at most."""
    cc = fhe.GenCryptoContext(_port_params(), seed=3, device="cpu")
    kp = cc.KeyGen()
    cc.EvalRotateKeyGen(kp.secret_key, [1, -3])
    cc.EvalConjugateKeyGen(kp.secret_key)
    z = np.random.default_rng(9).normal(size=cc.slots)
    ct = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(z))
    dec = lambda c: np.asarray(cc.Decrypt(kp.secret_key, c).values)
    base = dec(ct)
    for r in (1, -3):
        assert np.abs(dec(cc.EvalRotate(ct, r))
                      - np.roll(base, -r)).max() < 5e-2
    assert np.abs(dec(cc.EvalConjugate(ct)) - np.conj(base)).max() < 5e-2
    with pytest.raises(KeyError):
        cc.EvalRotate(ct, 2)                  # no key for 2
