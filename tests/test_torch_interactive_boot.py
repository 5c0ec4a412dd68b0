"""The port's interactive bootstrapping against the JAX package.

The context of `tests/test_interactive_boot.py` (CKKS, N=512, depth 8,
FLEXIBLEAUTO, seed 9, 8 slots) runs the JAX package's 2-party IntBoot*
and 3-party IntMPBoot* flows with its samplers recorded
(`test_torch_multiparty.record_draws`, which also runs the jitted
encryption of zero of IntBootEncrypt as its Python function). Every step
of the port, fed the same inputs and JAX's draws, must give JAX's words
with equal level, degree, scale and tag: IntBootAdjustScale,
IntBootDecrypt (both forms), IntBootEncrypt, IntBootAdd,
IntMPBootAdjustScale, IntMPBootRandomElementGen, IntMPBootDecrypt,
IntMPBootAdd and IntMPBootEncrypt; `_polynomial_round` and
`_extend_centered` too. The port's own flows (its own draws) decrypt
within that file's 1e-2, and the non-FLEXIBLE branch of both adjust-scale
functions runs on one FIXEDMANUAL context.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openfhe_tpu.pke import multiparty as jmp  # noqa: E402

from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch.math.modops import u32_tensor  # noqa: E402
from openfhe_tpu_torch.pke import multiparty as mp  # noqa: E402
from test_torch_multiparty import (ct, jax_context, pk,  # noqa: E402
                                   port_context, record_draws, sk,
                                   words_equal)

CTX = dict(scheme="CKKSRNS_SCHEME", ring_dim=512, mult_depth=8,
           scaling_mod_size=28, first_mod_size=30, batch_size=8,
           scaling_technique="FLEXIBLEAUTO")
X2 = np.array([0.25, -0.5, 0.75, 0.1, -0.3, 0.8, -0.2, 0.6])
X3 = np.linspace(-0.8, 0.8, 8)
TOL = 1e-2           # tests/test_interactive_boot.py's limit


def c1_only(c):
    return dataclasses.replace(c, elements=(c.elements[1],))


@pytest.fixture(scope="module")
def side():
    jcc = jax_context(9, **CTX)
    kp1 = jcc.MultipartyKeyGen()
    kp2 = jcc.MultipartyKeyGen(kp1.public_key)
    kp3 = jcc.MultipartyKeyGen(kp2.public_key)
    s = {}
    # two parties under kp2's joint key
    jct = jcc.LevelReduce(jcc.Encrypt(kp2.public_key,
                                      jcc.MakeCKKSPackedPlaintext(X2,
                                                                  slots=8)), 4)
    s["ct2"] = jct
    s["adj"] = adj = jcc.IntBootAdjustScale(jct)
    s["dec1"] = jcc.IntBootDecrypt(kp1.secret_key, adj)
    s["dec2"] = jcc.IntBootDecrypt(kp2.secret_key, c1_only(adj))
    with record_draws() as d:
        s["enc"] = jcc.IntBootEncrypt(kp2.public_key, s["dec2"])
    s["enc_draws"] = d
    s["add"] = jcc.IntBootAdd(s["enc"], s["dec1"])
    # three parties under kp3's joint key
    jct = jcc.LevelReduce(jcc.Encrypt(kp3.public_key,
                                      jcc.MakeCKKSPackedPlaintext(X3,
                                                                  slots=8)), 4)
    s["ct3"] = jct
    s["mp_adj"] = ctc = jcc.IntMPBootAdjustScale(jct)
    with record_draws() as d:
        s["a"] = a = jcc.IntMPBootRandomElementGen(kp3.public_key)
    s["a_draws"] = d
    with record_draws() as d:
        s["shares"] = [jcc.IntMPBootDecrypt(k.secret_key, c1_only(ctc), a)
                       for k in (kp1, kp2, kp3)]
    s["share_draws"] = d
    s["agg"] = jcc.IntMPBootAdd(s["shares"])
    s["mp_out"] = jcc.IntMPBootEncrypt(kp3.public_key, s["agg"], a, ctc)
    return dict(jcc=jcc, kp=(kp1, kp2, kp3), **s)


@pytest.fixture(scope="module")
def port(side):
    cc = port_context(9, **CTX)
    keys = [(sk(k.secret_key), pk(k.public_key)) for k in side["kp"]]
    return dict(cc=cc, sk=[k[0] for k in keys], pk=[k[1] for k in keys])


def test_int_boot_adjust_scale(side, port):
    """FLEXIBLE: Compress to 3, the scalar bring, ModReduce."""
    words_equal(port["cc"].IntBootAdjustScale(ct(side["ct2"])), side["adj"])


def test_int_boot_decrypt(side, port):
    """c0 + c1 s_1 and c1 s_2 (a c1-only input), each rounded."""
    cc = port["cc"]
    adj = ct(side["adj"])
    words_equal(cc.IntBootDecrypt(port["sk"][0], adj), side["dec1"])
    words_equal(cc.IntBootDecrypt(port["sk"][1], c1_only(adj)),
                side["dec2"])


def test_int_boot_encrypt(side, port):
    """The rounded share extended to the full chain plus an encryption of
    zero on JAX's draws (u, e0, e1)."""
    assert len(side["enc_draws"]) == 3
    got = mp.int_boot_encrypt_core(port["cc"], port["pk"][1],
                                   ct(side["dec2"]), side["enc_draws"])
    words_equal(got, side["enc"])


def test_int_boot_add(side, port):
    got = port["cc"].IntBootAdd(ct(side["enc"]), ct(side["dec1"]))
    words_equal(got, side["add"])
    assert port["cc"].size_ql(got.level) == 9


def test_two_party_flow_decrypts(port):
    """The port's own 2-party IntBoot (its own draws) refreshes the chain
    and decrypts within 1e-2."""
    cc = port_context(9, **CTX)
    kp1 = cc.MultipartyKeyGen()
    kp2 = cc.MultipartyKeyGen(kp1.public_key)
    c = cc.LevelReduce(cc.Encrypt(kp2.public_key, cc.MakeCKKSPackedPlaintext(
        X2, slots=8)), 4)
    before = cc.size_ql(c.level)
    adj = cc.IntBootAdjustScale(c)
    out1 = cc.IntBootDecrypt(kp1.secret_key, adj)
    out2 = cc.IntBootEncrypt(kp2.public_key,
                             cc.IntBootDecrypt(kp2.secret_key, c1_only(adj)))
    out = cc.IntBootAdd(out2, out1)
    assert cc.size_ql(out.level) > before
    parts = [cc.MultipartyDecryptLead([out], kp1.secret_key)[0],
             cc.MultipartyDecryptMain([out], kp2.secret_key)[0]]
    dec = cc.MultipartyDecryptFusion(parts, out)
    assert np.abs(dec.values.real[:8] - X2).max() < TOL


def test_int_mp_boot_adjust_scale(side, port):
    words_equal(port["cc"].IntMPBootAdjustScale(ct(side["ct3"])),
                side["mp_adj"])


def test_int_mp_boot_random_element(side, port):
    (crp,) = side["a_draws"]
    words_equal(mp.int_mp_boot_random_element_core(port["pk"][2], crp),
                side["a"])


def test_int_mp_boot_decrypt(side, port):
    """Each party's share pair on JAX's draws (mask, e0, e1): the centred
    mask shared by the compressed and the full chain."""
    cc = port["cc"]
    ctc, a = c1_only(ct(side["mp_adj"])), ct(side["a"])
    d = side["share_draws"]
    assert [tuple(x.shape) for x in d[:3]] == [(2, 512), (512,), (512,)]
    for i, s in enumerate(port["sk"]):
        got = mp.int_mp_boot_decrypt_core(cc, s, ctc, a, d[3 * i:3 * i + 3])
        words_equal(got, side["shares"][i])


def test_int_mp_boot_add_and_encrypt(side, port):
    cc = port["cc"]
    shares = [convert.share_pair_from_jax(pair, device="cpu")
              for pair in side["shares"]]
    agg = cc.IntMPBootAdd(shares)
    words_equal(agg, side["agg"])
    out = cc.IntMPBootEncrypt(port["pk"][2], agg, ct(side["a"]),
                              ct(side["mp_adj"]))
    words_equal(out, side["mp_out"])


def test_three_party_flow_decrypts(port):
    """The port's own 3-party IntMPBoot refreshes the chain and decrypts
    within 1e-2."""
    cc = port_context(9, **CTX)
    kps = [cc.MultipartyKeyGen()]
    for _ in range(2):
        kps.append(cc.MultipartyKeyGen(kps[-1].public_key))
    jpk = kps[-1].public_key
    c = cc.LevelReduce(cc.Encrypt(jpk, cc.MakeCKKSPackedPlaintext(
        X3, slots=8)), 4)
    before = cc.size_ql(c.level)
    ctc = cc.IntMPBootAdjustScale(c)
    a = cc.IntMPBootRandomElementGen(jpk)
    shares = [cc.IntMPBootDecrypt(k.secret_key, c1_only(ctc), a)
              for k in kps]
    out = cc.IntMPBootEncrypt(jpk, cc.IntMPBootAdd(shares), a, ctc)
    assert cc.size_ql(out.level) > before
    parts = ([cc.MultipartyDecryptLead(out, kps[0].secret_key)]
             + [cc.MultipartyDecryptMain(out, k.secret_key)
                for k in kps[1:]])
    dec = cc.MultipartyDecryptFusion(parts, out)
    assert np.abs(dec.values.real[:8] - X3).max() < TOL


def test_polynomial_round_and_extend_centered(side, port):
    """The host CRT steps on random words over 2 and 3 towers, with words
    near Q/4 and 3Q/4 in the rounding's input."""
    cc, jcc = port["cc"], side["jcc"]
    rng = np.random.default_rng(4)
    for size in (2, 3):
        mods = np.array(cc.moduli_q[:size], np.int64)[:, None]
        w = (rng.integers(0, 1 << 62, (size, 512)) % mods).astype(np.uint32)
        words_equal(mp._polynomial_round(cc, u32_tensor(w), size),
                    jmp._polynomial_round(jcc, w, size))
        words_equal(mp._extend_centered(cc, u32_tensor(w), size, 9),
                    jmp._extend_centered(jcc, w, size, 9))


def test_adjust_scale_fixed_branch():
    """Under FIXEDMANUAL both adjust-scale functions only compress."""
    kw = dict(CTX, scaling_technique="FIXEDMANUAL")
    jcc, cc = jax_context(9, **kw), port_context(9, **kw)
    kp = jcc.KeyGen()
    jct = jcc.LevelReduce(jcc.Encrypt(kp.public_key,
                                      jcc.MakeCKKSPackedPlaintext(X2,
                                                                  slots=8)), 2)
    for name in ("IntBootAdjustScale", "IntMPBootAdjustScale"):
        want = getattr(jcc, name)(jct)
        got = getattr(cc, name)(ct(jct))
        words_equal(got, want)
        assert got.num_towers == want.elements[0].shape[-2] < len(
            cc.moduli_q)
