"""The port's BV key switching against the JAX package, word for word.

`tests/test_keyswitch_bv.py`'s two CKKS contexts (N=256, depth 4,
FLEXIBLEAUTO, BV with digit_size 0, the pure RNS decomposition, and 5,
the relinearization window): the JAX package makes the keys (`convert`
carries them over in `bv.keyswitch_gen`'s layout) and the ciphertexts;
EvalMult, Relinearize, EvalRotate (window 5), KeySwitch and the key
switch core of each form must give the JAX words, the decryptions within
the JAX test's limits (a KeySwitch of a fresh ciphertext with RNS digits
carries noise of the size of a tower and is not decrypted). The BV tables
equal the JAX package's. Then the BV rows of `tests/test_matrix.py` for
BGV (every scaling technique, one secret distribution a row) and BFV,
digit_size 5.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openfhe_tpu.pke.keyswitch import bv as jbv  # noqa: E402

from openfhe_tpu_torch.math.modops import to_u32  # noqa: E402
from openfhe_tpu_torch.pke.keyswitch import bv  # noqa: E402
from test_torch_bgv import (assert_same, carry_keys,  # noqa: E402
                            check_each, ct, jax_context, matrix_case,
                            port_context, port_key)

CKKS = dict(scheme="CKKSRNS_SCHEME", ring_dim=256, mult_depth=4,
            scaling_mod_size=28, first_mod_size=30, batch_size=8,
            scaling_technique="FLEXIBLEAUTO", ks_technique="BV")


@functools.lru_cache(maxsize=None)
def _sides(digit_size):
    kw = dict(CKKS, digit_size=digit_size)
    jcc = jax_context(4, **kw)
    kp = jcc.KeyGen()
    kp2 = jcc.KeyGen()
    jcc.EvalMultKeyGen(kp.secret_key)
    if digit_size:
        jcc.EvalRotateKeyGen(kp.secret_key, [1])
    jek = jcc.KeySwitchGen(kp.secret_key, kp2.secret_key)
    rng = np.random.default_rng(1)
    x = rng.normal(size=8) * 0.5
    jx = jcc.Encrypt(kp.public_key, jcc.MakeCKKSPackedPlaintext(x, slots=8))
    jsq = jcc.EvalMult(jx, jx)
    want = {"mult": jsq,
            "relinearize": jcc.Relinearize(jcc.EvalMultNoRelin(jx, jx)),
            "keyswitch": jcc.KeySwitch(jx, jek),
            "mult_rescaled": jcc.EvalMult(jcc.ModReduce(jsq), jx)}
    if digit_size:
        want["rotate"] = jcc.EvalRotate(jx, 1)
    cc = port_context(4, **kw)
    sk = carry_keys(jcc, cc, kp)
    ek = port_key(jek, jek.key_tag)
    sk2 = carry_keys(jcc, cc, kp2)
    return dict(jcc=jcc, cc=cc, sk=sk, sk2=sk2, ek=ek, jek=jek, x=x, jx=jx,
                want=want)


def _run(cc, s, op):
    x = ct(s["jx"])
    if op == "mult":
        return cc.EvalMult(x, x)
    if op == "relinearize":
        return cc.Relinearize(cc.EvalMultNoRelin(x, x))
    if op == "keyswitch":
        return cc.KeySwitch(x, s["ek"])
    if op == "mult_rescaled":
        return cc.EvalMult(cc.ModReduce(cc.EvalMult(x, x)), x)
    return cc.EvalRotate(x, 1)


@pytest.mark.parametrize("digit_size", [0, 5], ids=["rns", "window5"])
def test_ckks_ops_match_jax(digit_size):
    """EvalMult, Relinearize, KeySwitch, EvalMult after ModReduce and
    (window 5) EvalRotate, each against the JAX op's result and its
    decryption against the slots."""
    s = _sides(digit_size)
    x = s["x"]
    truth = {"mult": x * x, "relinearize": x * x, "keyswitch": x,
             "mult_rescaled": x ** 3, "rotate": np.roll(x, -1)}

    def check(op):
        got = _run(s["cc"], s, op)
        want = s["want"][op]
        assert_same(got, want)
        assert got.scale == want.scale
        if digit_size == 0 and op == "keyswitch":
            return  # RNS digits of ~q_i: noise too large for a degree-1 ct
        key = s["sk2"] if op == "keyswitch" else s["sk"]
        dec = s["cc"].Decrypt(key, got).values.real[:8]
        assert np.abs(dec - truth[op]).max() < (1e-2 if op == "rotate"
                                                else 1e-3)

    check_each(s["want"], check)


@pytest.mark.parametrize("digit_size", [0, 5])
def test_keys_and_tables_match_jax(digit_size):
    """The key layout (a row per tower, or per tower and digit), the digit
    count and the per-tower conversion tables at every level."""
    s = _sides(digit_size)
    cc, jcc = s["cc"], s["jcc"]
    assert cc.moduli_q == list(jcc.moduli_q) and cc.moduli_p == []
    kq = len(cc.moduli_q)
    rows = kq * (bv._digit_count(cc.basis_q, kq, digit_size)
                 if digit_size else 1)
    assert tuple(s["ek"].bv.shape) == (rows, kq, cc.ring_dim)
    if digit_size:
        assert bv._digit_count(cc.basis_q, kq, 5) == jbv._digit_count(
            jcc.basis_q, kq, 5)
    for size in range(1, kq + 1):
        tabs, jtabs = cc.bv_tables(size), jcc.bv_tables(size)
        assert tabs.size_ql == jtabs.size_ql
        for pt, jpt in zip(tabs.parts, jtabs.parts):
            assert pt.compl_basis.moduli == tuple(jpt.compl_basis.moduli)
            got = to_u32(pt.switch.bhat_mod_d)
            np.testing.assert_array_equal(
                got, np.asarray(jpt.switch.bhat_mod_d).reshape(got.shape))


@pytest.mark.parametrize("digit_size", [0, 5])
def test_keyswitch_core_matches_jax(digit_size):
    """The core of each form alone, on the fresh ciphertext's c1 at every
    level the chain has."""
    s = _sides(digit_size)
    cc, jcc = s["cc"], s["jcc"]
    c1 = ct(s["jx"]).elements[1]
    jc1 = s["jx"].elements[1]
    for size in (len(cc.moduli_q), 2, 1):
        got = cc._keyswitch_core(c1[:size].contiguous(), s["ek"], size)
        want = jcc._keyswitch_core(jc1[:size], s["jek"], size)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_u32(g), np.asarray(w))


def test_no_hoisting_under_bv():
    s = _sides(5)
    assert s["cc"].EvalFastRotationPrecompute(ct(s["jx"])) is None
    assert_same(s["cc"].EvalFastRotation(ct(s["jx"]), 1, 0, None),
                s["want"]["rotate"])


# ---------------------------------------------------------------------------
# tests/test_matrix.py's BV rows for BGV and BFV
# ---------------------------------------------------------------------------

MATRIX = [("BGVRNS_SCHEME", "FIXEDMANUAL", "UNIFORM_TERNARY"),
          ("BGVRNS_SCHEME", "FIXEDAUTO", "GAUSSIAN"),
          ("BGVRNS_SCHEME", "FLEXIBLEAUTO", "UNIFORM_TERNARY"),
          ("BGVRNS_SCHEME", "FLEXIBLEAUTOEXT", "SPARSE_TERNARY"),
          ("BFVRNS_SCHEME", "FIXEDMANUAL", "SPARSE_TERNARY")]


@pytest.mark.parametrize("scheme,scal,dist", MATRIX,
                         ids=["-".join(c) for c in MATRIX])
def test_matrix_row_matches_jax(scheme, scal, dist):
    matrix_case(scheme, "BV", dist, scal)
