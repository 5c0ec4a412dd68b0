"""The port's proxy re-encryption against the JAX package, word for word.

`examples/pre.py`'s BGV (N=2^11, depth 2, t=65537, FLEXIBLEAUTO, three
digits) under each mode, INDCPA, FIXED_NOISE_HRA and NOISE_FLOODING_HRA:
ReKeyGen by secret key (KeySwitchGen's draws) and by public key
(`hybrid.keyswitch_gen_pk`'s), and ReEncrypt under both keys at levels 0
and 1, on the JAX package's recorded draws
(`test_torch_multiparty.record_draws`), give JAX's words and tags. Then
the CKKS context of `tests/test_serialize_pre_multiparty.py`, a two-hop
chain (Alice -> Bob by secret key, Bob -> Carol by public key) of the
port's own draws decrypting exactly, ReEncrypt through the fused chain
(tables with t attached on the CPU) equal to the unfused one, and PRE
under BV key switching: the JAX package's ReEncrypt and ReKeyGen by
public key fail there (an AttributeError: BV has no P towers), the
port's raise a ValueError, and ReKeyGen by secret key gives JAX's BV key.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openfhe_tpu_torch.math import modops as mo  # noqa: E402
from openfhe_tpu_torch.pke import pre  # noqa: E402
from openfhe_tpu_torch.pke.keyswitch import hybrid  # noqa: E402
from test_torch_multiparty import (CKKS, ct, jax_context,  # noqa: E402
                                   keyswitch_gen_core, pk, port_context,
                                   record_draws, sk, with_fused_tables,
                                   words_equal)

T = 65537
BGV = dict(scheme="BGVRNS_SCHEME", ring_dim=1 << 11, mult_depth=2,
           plaintext_modulus=T)
MODES = ("INDCPA", "FIXED_NOISE_HRA", "NOISE_FLOODING_HRA")


def jax_run(kw, seed, values, lower: bool):
    """Alice's encryption of `values` (and, with `lower`, the same one
    level lower), the two re-keys and the re-encryptions, each random
    step recorded."""
    jcc = jax_context(seed, **kw)
    alice, bob = jcc.KeyGen(), jcc.KeyGen()
    x = jcc.Encrypt(alice.public_key, (
        jcc.MakePackedPlaintext(values) if kw["scheme"] == "BGVRNS_SCHEME"
        else jcc.MakeCKKSPackedPlaintext(values)))
    ins = [x, jcc.LevelReduce(x, 1)] if lower else [x]
    run = dict(jcc=jcc, alice=alice, bob=bob, ins=ins)
    with record_draws() as d:
        run["rk_sk"] = jcc.ReKeyGen(alice.secret_key, bob.secret_key)
    run["rk_sk_draws"] = d
    with record_draws() as d:
        run["rk_pk"] = jcc.ReKeyGen(alice.secret_key, bob.public_key)
    run["rk_pk_draws"] = d
    run["out"], run["out_draws"] = [], []
    for c in run["ins"]:
        for rk, key in (("rk_sk", None), ("rk_pk", bob.public_key)):
            with record_draws() as d:
                run["out"].append(jcc.ReEncrypt(c, run[rk], key))
            run["out_draws"].append(d)
    return run


def port_replay(run, kw, seed):
    """The port's cores on the JAX run's draws."""
    cc = port_context(seed, **kw)
    a_sk = sk(run["alice"].secret_key)
    b_sk, b_pk = sk(run["bob"].secret_key), pk(run["bob"].public_key)
    rk_sk = keyswitch_gen_core(cc, run["rk_sk_draws"], a_sk, b_sk)
    rk_pk = pre.re_key_gen_pk_core(cc, a_sk, b_pk, run["rk_pk_draws"])
    outs = []
    draws = iter(run["out_draws"])
    for c in run["ins"]:
        for rk, key in ((rk_sk, None), (rk_pk, b_pk)):
            outs.append(pre.re_encrypt_core(cc, ct(c), rk, key, next(draws)))
    return cc, b_sk, rk_sk, rk_pk, outs


@pytest.mark.parametrize("mode", MODES)
def test_bgv_re_key_gen_and_re_encrypt(mode):
    """Both re-keys and four re-encryptions (level 0 and level 1, each
    under both keys) on JAX's draws; the draws per mode (FIXED_NOISE_HRA:
    an encryption of zero when the public key is given; flooding: one
    Gaussian of sigma 2^20)."""
    kw = dict(BGV, pre_mode=mode)
    vals = np.random.default_rng(5).integers(0, T, 1 << 11)
    run = jax_run(kw, 5, vals, lower=True)
    want_draws = {"INDCPA": [0, 0], "FIXED_NOISE_HRA": [0, 3],
                  "NOISE_FLOODING_HRA": [1, 1]}[mode] * 2
    assert [len(d) for d in run["out_draws"]] == want_draws
    cc, b_sk, rk_sk, rk_pk, outs = port_replay(run, kw, 5)
    words_equal([rk_sk, rk_pk], [run["rk_sk"], run["rk_pk"]])
    words_equal(outs, run["out"])
    assert [o.level for o in outs] == [0, 0, 1, 1]
    for out in outs:
        got = np.asarray(cc.Decrypt(b_sk, out).values)
        np.testing.assert_array_equal(got % T, vals)


def test_ckks_re_key_gen_and_re_encrypt():
    """The CKKS context under INDCPA: the same steps on a fresh
    encryption, decrypting within 1e-3."""
    x = np.linspace(-1, 1, 128)
    run = jax_run(CKKS, 3, x, lower=False)
    cc, b_sk, rk_sk, rk_pk, outs = port_replay(run, CKKS, 3)
    words_equal([rk_sk, rk_pk], [run["rk_sk"], run["rk_pk"]])
    words_equal(outs, run["out"])
    assert np.abs(cc.Decrypt(b_sk, outs[1]).values.real - x).max() < 1e-3
    assert len(outs) == 2


@pytest.mark.parametrize("mode", MODES)
def test_two_hop_chain_decrypts_exactly(mode):
    """The port's own draws: Alice -> Bob by secret key, Bob -> Carol by
    public key, at level 0 and after an EvalMult, exact mod t; through the
    fused chain (tables attached on the CPU) the same words as through the
    unfused one."""
    kw = dict(BGV, pre_mode=mode)
    plain = port_context(7, **kw)
    fused = with_fused_tables(port_context(7, **kw))
    alice, bob, carol = (plain.KeyGen() for _ in range(3))
    plain.EvalMultKeyGen(alice.secret_key)
    rng = np.random.default_rng(7)
    u, v = (rng.integers(0, T, 1 << 11) for _ in range(2))
    x = plain.Encrypt(alice.public_key, plain.MakePackedPlaintext(u))
    y = plain.Encrypt(alice.public_key, plain.MakePackedPlaintext(v))
    ab = plain.ReKeyGen(alice.secret_key, bob.secret_key)
    bc = plain.ReKeyGen(bob.secret_key, carol.public_key)
    for c, want in ((x, u), (plain.EvalMult(x, y), u * v % T)):
        to_bob = plain.ReEncrypt(c, ab)
        to_carol = plain.ReEncrypt(to_bob, bc, carol.public_key)
        got = np.asarray(plain.Decrypt(carol.secret_key, to_carol).values)
        np.testing.assert_array_equal(got % T, want)
        assert to_carol.key_tag == carol.public_key.key_tag
        # fused == unfused: INDCPA has no draws; the others' draws are
        # given to both cores
        draws = pre.re_encrypt_draws(plain, carol.public_key)
        one, two = (pre.re_encrypt_core(cx, to_bob, bc, carol.public_key,
                                        draws) for cx in (plain, fused))
        assert fused.hybrid_tables(to_bob.num_towers).fused is not None
        for a, b in zip(one.elements, two.elements):
            assert torch.equal(a, b)


def test_pre_under_bv():
    """BV key switching: the JAX package's ReEncrypt and ReKeyGen by
    public key fail, the port refuses both with a ValueError; ReKeyGen by
    secret key gives JAX's BV key (a digit a tower, P = 1)."""
    kw = dict(BGV, ks_technique="BV")
    jcc = jax_context(5, **kw)
    alice, bob = jcc.KeyGen(), jcc.KeyGen()
    jct = jcc.Encrypt(alice.public_key, jcc.MakePackedPlaintext([1, 2, 3]))
    with record_draws() as d:
        jrk = jcc.ReKeyGen(alice.secret_key, bob.secret_key)
    with pytest.raises(AttributeError):
        jcc.ReEncrypt(jct, jrk)
    with pytest.raises(AttributeError):
        jcc.ReKeyGen(alice.secret_key, bob.public_key)
    cc = port_context(5, **kw)
    k_q = len(cc.moduli_q)
    ones, ones_sh = mo.shoup_pair([1] * k_q, cc.moduli_q)
    rk = hybrid.keyswitch_gen_core(d, sk(alice.secret_key),
                                   sk(bob.secret_key), cc.basis_q, k_q, k_q,
                                   ones, ones_sh, cc.noise_scale_int)
    words_equal(rk, jrk)
    with pytest.raises(ValueError, match="HYBRID"):
        cc.ReEncrypt(ct(jct), rk)
    with pytest.raises(ValueError, match="HYBRID"):
        cc.ReKeyGen(sk(alice.secret_key), pk(bob.public_key))
    assert cc.ReKeyGen(sk(alice.secret_key),
                       sk(bob.secret_key)).bv.shape == rk.bv.shape
