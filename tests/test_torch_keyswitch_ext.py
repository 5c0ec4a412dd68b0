"""The port's extended-basis family against the JAX package, word for word.

`tests/test_keyswitch_ext.py`'s CKKS context (N=512, depth 4,
FLEXIBLEAUTO, HYBRID, seed 11): the JAX package makes the keys and a
ciphertext, `convert` carries them over (the metadata map too).
KeySwitchExt (with and without element 0), EvalFastRotationExt over
rotations 1, 2, 3 (with and without c0), EvalAddExt, EvalSubExt,
KeySwitchDown and KeySwitchDownFirstElement must give the JAX words and
the "ext_basis" entry; the sum of the rotations, moved down once,
decrypts to the sum of the rotated slots. A generic KeySwitch to a second
key and SparseKeyGen round-trip, and MakePlaintext dispatches on the
encoding. BGV's mod-down with t follows the same ops
(`tests/test_torch_bgv.py` holds `approx_mod_down` with t).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openfhe_tpu.pke import constants as jc  # noqa: E402

from openfhe_tpu_torch.math.modops import to_u32  # noqa: E402
from openfhe_tpu_torch.pke import constants as tc  # noqa: E402
from test_torch_bgv import (assert_same, carry_keys,  # noqa: E402
                            check_each, ct, jax_context, port_context,
                            port_key)

KW = dict(scheme="CKKSRNS_SCHEME", ring_dim=512, mult_depth=4,
          scaling_mod_size=28, first_mod_size=30, batch_size=8,
          scaling_technique="FLEXIBLEAUTO")
ROTS = (1, 2, 3)


def _ladder(cc, x, add_first=True):
    """EvalFastRotationExt over ROTS summed by EvalAddExt; returns the
    terms, the sum, KeySwitchDown of it and its first element alone."""
    digits = cc.EvalFastRotationPrecompute(x)
    terms = [cc.EvalFastRotationExt(x, r, digits, add_first=add_first)
             for r in ROTS]
    acc = terms[0]
    for t in terms[1:]:
        acc = cc.EvalAddExt(acc, t)
    return terms, acc, cc.KeySwitchDown(acc), cc.KeySwitchDownFirstElement(
        acc)


def _ops(cc, x, ek):
    terms, acc, down, first = _ladder(cc, x)
    terms0, acc0, down0, first0 = _ladder(cc, x, add_first=False)
    return {"rot1_ext": terms[0], "rot3_ext": terms[2], "sum_ext": acc,
            "down": down, "first": first, "rot2_ext_no_c0": terms0[1],
            "down_no_c0": down0, "first_no_c0": first0,
            "sub_ext": cc.EvalSubExt(acc, terms[1]),
            "keyswitch_ext": cc.KeySwitchExt(x),
            "keyswitch_ext_no_c0": cc.KeySwitchExt(x, add_first=False),
            "keyswitch_ext_down": cc.KeySwitchDown(cc.KeySwitchExt(x)),
            "keyswitch": cc.KeySwitch(x, ek)}


@functools.lru_cache(maxsize=None)
def _sides():
    jcc = jax_context(11, **KW)
    kp = jcc.KeyGen()
    jcc.EvalMultKeyGen(kp.secret_key)
    jcc.EvalRotateKeyGen(kp.secret_key, list(ROTS))
    kp2 = jcc.KeyGen()
    jek = jcc.KeySwitchGen(kp.secret_key, kp2.secret_key)
    x = np.linspace(-1, 1, 8)
    jx = jcc.Encrypt(kp.public_key, jcc.MakeCKKSPackedPlaintext(x, slots=8))
    want = _ops(jcc, jx, jek)
    cc = port_context(11, **KW)
    sk = carry_keys(jcc, cc, kp)
    sk2 = carry_keys(jcc, cc, kp2)
    got = _ops(cc, ct(jx), port_key(jek, jek.key_tag))
    return dict(cc=cc, jcc=jcc, sk=sk, sk2=sk2, x=x, want=want, got=got)


OPS = ("rot1_ext", "rot3_ext", "sum_ext", "down", "rot2_ext_no_c0",
       "down_no_c0", "sub_ext", "keyswitch_ext", "keyswitch_ext_no_c0",
       "keyswitch_ext_down", "keyswitch")


def test_ops_match_jax():
    """Each op's words, level, degree, scale and metadata against JAX's;
    the extended ones carry "ext_basis" and Q_l*P towers."""
    s = _sides()

    def check(op):
        got, want = s["got"][op], s["want"][op]
        assert_same(got, want)
        assert got.scale == want.scale
        if op.endswith("_ext") or (op.startswith("keyswitch_ext")
                                   and op != "keyswitch_ext_down"):
            assert got.GetMetadataByKey("ext_basis") is True
            assert got.num_towers == len(s["cc"].moduli_q) + len(
                s["cc"].moduli_p)

    check_each(OPS, check)


def test_down_first_element_matches_jax():
    s = _sides()

    def check(which):
        got, want = s["got"][which], s["want"][which]
        np.testing.assert_array_equal(to_u32(got), np.asarray(want))
        down = s["got"]["down" + which[len("first"):]]
        assert torch.equal(got, down.elements[0])

    check_each(("first", "first_no_c0"), check)


def test_ladder_decrypts_to_the_rotation_sum():
    """One KeySwitchDown after the sum: the sum of the rotated slots, as
    the JAX test holds it (1e-2); the generic KeySwitch decrypts under
    the second key."""
    s = _sides()
    cc, x = s["cc"], s["x"]
    down = s["got"]["down"]
    assert down.GetMetadataByKey("ext_basis") is False
    got = cc.Decrypt(s["sk"], down).values.real[:8]
    assert np.abs(got - sum(np.roll(x, -r) for r in ROTS)).max() < 1e-2
    ks = cc.Decrypt(s["sk2"], s["got"]["keyswitch"]).values.real[:8]
    assert np.abs(ks - x).max() < 1e-3


def test_metadata_map():
    s = _sides()
    c = s["got"]["down"]
    assert c.FindMetadataByKey("ext_basis")
    d = c.SetMetadataByKey("note", 3).SetMetadataByKey("note", 4)
    assert d.GetMetadataMap() == {"ext_basis": False, "note": 4}
    assert c.GetMetadataMap() == {"ext_basis": False}
    with pytest.raises(KeyError):
        c.GetMetadataByKey("missing")
    z = c.CloneZero()
    assert not any(e.any() for e in z.elements)
    assert z.metadata == c.metadata and c.Clone() == c


def test_sparse_keygen_and_make_plaintext():
    """SparseKeyGen's secret has Hamming weight 192; a round trip through
    MakePlaintext(CKKS_PACKED_ENCODING) decrypts within 1e-3."""
    s = _sides()
    cc, x = s["cc"], s["x"]
    kp = cc.SparseKeyGen()
    from openfhe_tpu_torch.ops.ntt import ntt_inv
    coeff = ntt_inv(kp.secret_key.s_qp[:1], cc.basis_q.slice(0, 1))[0]
    q0 = cc.moduli_q[0]
    assert int(((coeff != 0)).sum()) == 192
    assert bool(((coeff == 1) | (coeff == q0 - 1) | (coeff == 0)).all())
    pt = cc.MakePlaintext(tc.PlaintextEncodings.CKKS_PACKED_ENCODING, x)
    jpt = s["jcc"].MakePlaintext(jc.PlaintextEncodings.CKKS_PACKED_ENCODING,
                                 x)
    np.testing.assert_allclose(to_u32(pt.poly).astype(np.int64),
                               np.asarray(jpt.poly).astype(np.int64),
                               rtol=0, atol=0)
    dec = cc.Decrypt(kp.secret_key, cc.Encrypt(kp.public_key, pt))
    assert np.abs(dec.values.real[:8] - x).max() < 1e-3
    with pytest.raises(ValueError, match="requires BGV/BFV"):
        cc.MakePlaintext(tc.PlaintextEncodings.PACKED_ENCODING, [1, 2])
