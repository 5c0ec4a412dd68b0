"""The port's composite-Q BinFHE ring (`binfhe/rgsw_wide.py` and the wide
paths of `binfhe/context.py` / `lwe.py`) against the JAX package, word for
word.

One module fixture makes the JAX package's custom wide context of its own
tests (n = 16, N = 512, q = 1024, q_bits = 34: Q = q1 * q2 of 35 bits,
seed 5) with its keys and three encryptions, and carries them into a port
context on the CPU with `convert`. Every gate, Bootstrap and EvalFunc x^2
mod 4 must return the JAX words exactly, and the pieces too: the
parameters of every named set of more than 31 bits of Q, the Garner words
and the signed digits at 34 and 38 bits, the interleaved decomposition,
one blind rotation from a JAX key, and the exact mod switch from Q = 2^38
(int64) and from a 50-bit Q (Python integers past 2^63). The JAX package
runs with the exact mod switch of `test_torch_binfhe.py` in place of its
device one, as that file does. On the CPU the NTTs are the plain stage
loop and the blind rotation the per-step loop; on the card they are
kernel m and `blind_rotate_cggi_wide`, which `chip_smoke.py` runs in its
STD192 phase.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openfhe_tpu.binfhe import lwe as jlwe  # noqa: E402
from openfhe_tpu.binfhe import rgsw_wide as jrw  # noqa: E402
from openfhe_tpu.binfhe.constants import BINGATE as JGATE  # noqa: E402
from openfhe_tpu.binfhe.constants import PARAM_SETS as JSETS  # noqa: E402
from openfhe_tpu.binfhe.context import BinFHEContext as JContext  # noqa: E402

from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch.binfhe import lwe, rgsw_wide  # noqa: E402
from openfhe_tpu_torch.binfhe.constants import (BINFHE_METHOD, BINGATE,  # noqa
                                                KEYGEN_MODE, PARAM_SETS)
from openfhe_tpu_torch.binfhe.context import BinFHEContext  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32, u32_tensor  # noqa: E402
from test_torch_binfhe import (GATES, M1, M2, M3, _exact_mod_switch,  # noqa
                               _port_ct, _same)

WIDE = dict(n=16, N=512, q=1024, q_bits=34, base_ks=25, base_g=1 << 9)
WIDE_SETS = sorted(k for k, p in PARAM_SETS.items() if p.number_bits > 31)


@pytest.fixture(scope="module", autouse=True)
def _jax_exact_mod_switch():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlwe, "mod_switch_device", _exact_mod_switch)
        yield


@pytest.fixture(scope="module")
def wide():
    jcc = JContext(seed=5).GenerateBinFHEContextCustom(**WIDE)
    jsk = jcc.KeyGen()
    jcc.BTKeyGen(jsk)
    cc = BinFHEContext(seed=5, device="cpu").GenerateBinFHEContextCustom(
        **WIDE)
    assert cc.wide and jcc.wide
    assert (cc.n, cc.N, cc.q, cc.Q, cc.q_ks) == (jcc.n, jcc.N, jcc.q, jcc.Q,
                                                 jcc.q_ks)
    ks = jcc.ks_key
    cc.ks_key = convert.switching_key_from_numpy(
        np.asarray(ks.a), np.asarray(ks.b), ks.mod_ks, ks.base_ks,
        device="cpu")
    cc.bt_key = convert.bt_key_from_numpy(jcc.method, jcc.bt_key, "cpu")
    sk = convert.lwe_secret_from_numpy(np.asarray(jsk.s), device="cpu")
    jcts = [jcc.Encrypt(jsk, jnp.asarray(m, jnp.uint32)) for m in (M1, M2,
                                                                     M3)]
    return jcc, jsk, cc, sk, jcts, [_port_ct(c) for c in jcts]


def test_wide_params_match_jax_for_every_wide_set():
    """q1, q2, Q, digitsG and the psi powers of every named set with more
    than 31 bits of Q, and of the custom context."""
    rows = [(p.lattice_param, p.cyc_order // 2, p.number_bits, p.mod,
             p.base_g) for p in (PARAM_SETS[k] for k in WIDE_SETS)]
    assert len(rows) == len([k for k, p in JSETS.items()
                             if p.number_bits > 31]) >= 12
    rows.append((WIDE["n"], WIDE["N"], WIDE["q_bits"], WIDE["q"],
                 WIDE["base_g"]))
    for n, big_n, bits, q, base_g in rows:
        got = rgsw_wide.make_rgsw_wide_params(n, big_n, bits, q, base_g)
        want = jrw.make_rgsw_wide_params(n, big_n, bits, q, base_g)
        assert got.moduli == tuple(int(m) for m in want.basis.moduli)
        assert (got.big_q, got.digits_g, got.digits_g2) == (
            want.big_q, want.digits_g, want.digits_g2)
        np.testing.assert_array_equal(got.psi_pow.numpy(),
                                      np.asarray(want.psi_pow))
        np.testing.assert_array_equal(got.eval_exp.numpy(),
                                      np.asarray(want.eval_exp))


@pytest.mark.parametrize("q_bits,base_g", [(34, 1 << 7), (38, 1 << 13)])
def test_garner_digits_and_decompose_words(q_bits, base_g):
    """The Garner value, the balanced digits (with digit 0 and without)
    and the interleaved decomposition of a pair, at the edges (0, 1, Q - 1,
    Q/2 +- 1, digit boundaries) and on random residues."""
    n_ring = 64
    params = rgsw_wide.make_rgsw_wide_params(8, n_ring, q_bits, 128, base_g)
    jp = jrw.make_rgsw_wide_params(8, n_ring, q_bits, 128, base_g)
    big_q, mods = params.big_q, params.moduli
    rng = np.random.default_rng(q_bits)
    x = rng.integers(0, big_q, size=(2, n_ring), dtype=np.int64)
    edge = [0, 1, big_q - 1, big_q // 2, big_q // 2 - 1, big_q // 2 + 1,
            base_g // 2, base_g - 1, big_q - base_g // 2]
    edge += [(base_g // 2) * base_g ** k for k in (1, 2)]
    x[0, :len(edge)] = edge
    x[1, :len(edge)] = [(big_q - v) % big_q for v in edge]
    res = np.stack([x % m for m in mods], axis=-2)       # [2, 2, N]
    hi, lo = jrw.garner_pair(jp, jnp.asarray(res[0].astype(np.uint32)))
    got = rgsw_wide.garner(params, u32_tensor(res[0]))
    np.testing.assert_array_equal(
        got.numpy(), (np.asarray(hi).astype(np.int64) << 32)
        + np.asarray(lo).astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), x[0])
    for drop in (True, False):
        jd = jrw.signed_digits_pair(jp, hi, lo, drop_first=drop)
        pd = rgsw_wide.signed_digits(params, got, drop_first=drop)
        assert len(pd) == len(jd)
        for a, b in zip(pd, jd):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jr = jrw.digits_to_residues(jp, jd)
    np.testing.assert_array_equal(
        to_u32(rgsw_wide.digits_to_residues(params, pd)), np.asarray(jr))
    want = jrw.signed_digit_decompose_wide(
        jp, *(jnp.asarray(r.astype(np.uint32)) for r in res))
    np.testing.assert_array_equal(
        to_u32(rgsw_wide.signed_digit_decompose_wide(
            params, *(u32_tensor(r) for r in res))), np.asarray(want))


def test_eval_acc_cggi_wide_words(wide):
    """One blind rotation over three steps of the JAX key, random
    accumulators and a, at batch 4 (the gates' shapes)."""
    jcc, _, cc, _, _, _ = wide
    rng = np.random.default_rng(7)
    mods = cc.rgsw_w.moduli
    acc = np.stack([rng.integers(0, m, size=(2, 4, cc.N)) for m in mods],
                   axis=-2)                               # [2, 4, 2, N]
    a = rng.integers(0, cc.q, size=(4, cc.n), dtype=np.int64)
    a[:, 3:] = 0                                          # three steps
    j0, j1 = jrw.eval_acc_cggi_wide(
        jcc.rgsw_w, jcc.bt_key[:3], *(jnp.asarray(v.astype(np.uint32))
                                      for v in (acc[0], acc[1], a[:, :3])))
    p0, p1 = rgsw_wide.eval_acc_cggi_wide(
        cc.rgsw_w.replace(n_lwe=3), cc.bt_key[:3],
        *(u32_tensor(v) for v in (acc[0], acc[1], a[:, :3])))
    np.testing.assert_array_equal(to_u32(p0), np.asarray(j0))
    np.testing.assert_array_equal(to_u32(p1), np.asarray(j1))


@pytest.mark.parametrize("gate,fn", GATES[:4], ids=[g for g, _ in GATES[:4]])
def test_wide_gate_words(wide, gate, fn):
    jcc, jsk, cc, sk, jcts, cts = wide
    out = cc.EvalBinGate(BINGATE[gate], cts[0], cts[1])
    _same(out, jcc.EvalBinGate(JGATE[gate], jcts[0], jcts[1]))
    np.testing.assert_array_equal(cc.Decrypt(sk, out), fn(M1, M2))


def test_wide_bootstrap_not_and_majority_words(wide):
    jcc, jsk, cc, sk, jcts, cts = wide
    out = cc.Bootstrap(cts[0])
    _same(out, jcc.Bootstrap(jcts[0]))
    np.testing.assert_array_equal(cc.Decrypt(sk, out), M1)
    _same(cc.EvalNOT(cts[1]), jcc.EvalNOT(jcts[1]))
    out = cc.EvalBinGate(BINGATE.MAJORITY, cts)
    _same(out, jcc.EvalBinGate(JGATE.MAJORITY, jcts))
    np.testing.assert_array_equal(cc.Decrypt(sk, out),
                                  (M1 + M2 + M3 >= 2) * 1)


def test_wide_eval_func_words(wide):
    """EvalFunc x^2 mod 4 (a periodic LUT: two functional bootstraps)."""
    jcc, jsk, cc, sk, _, _ = wide
    p = 4
    x = np.arange(p)
    lut = cc.GenerateLUTviaFunction(lambda m, pp: (m * m) % pp, p)
    jct = jcc.Encrypt(jsk, jnp.asarray(x, jnp.uint32), p=p)
    out = cc.EvalFunc(_port_ct(jct), lut)
    _same(out, jcc.EvalFunc(jct, lut))
    np.testing.assert_array_equal(cc.Decrypt(sk, out, p=p), x * x % p)


@pytest.mark.parametrize("q_from,q_to", [(1 << 38, 1 << 15),
                                         ((1 << 50) - 27, 1 << 21)])
def test_wide_mod_switch_words(q_from, q_to):
    """From Q = 2^38 (int64 on the device) and from a 50-bit Q into a
    21-bit qKS (past 2^63: Python integers, the JAX package's object-int
    path), against JAX and the exact rounding."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, q_from, size=(3, 257), dtype=np.int64)
    x[0, :5] = [0, 1, q_from - 1, q_from // 2, q_from // 2 + 1]
    jct = jlwe.LWECiphertext(a=x, b=x[:, 0].copy(), modulus=q_from,
                             pt_modulus=4)
    ct = lwe.LWECiphertext(a=torch.from_numpy(x),
                           b=torch.from_numpy(x[:, 0].copy()),
                           modulus=q_from)
    got = lwe.mod_switch(q_to, ct)
    want = jlwe.mod_switch(q_to, jct)
    assert got.a.dtype == torch.int32 and got.modulus == q_to
    np.testing.assert_array_equal(to_u32(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(to_u32(got.b), np.asarray(want.b))
    exact = [(int(v) * 2 * q_to + q_from) // (2 * q_from) % q_to
             for v in x.reshape(-1)]
    np.testing.assert_array_equal(to_u32(got.a).reshape(-1), exact)


def test_wide_sets_build_and_refuse_as_jax_does():
    """STD192 builds on the composite ring (Q of 38 bits, n = 821, N =
    2048); AP and LMKCDEY on a wide set, and PUB_ENCRYPT's BTKeyGen, raise
    the ValueErrors the JAX package raises."""
    cc = BinFHEContext(device="cpu").GenerateBinFHEContext("STD192")
    jcc = JContext().GenerateBinFHEContext("STD192")
    assert cc.wide and (cc.n, cc.N, cc.Q, cc.q_ks) == (821, 2048, jcc.Q,
                                                       jcc.q_ks)
    assert cc.rgsw_w.moduli == tuple(int(m)
                                     for m in jcc.rgsw_w.basis.moduli)
    for name, method in (("STD192_LMKCDEY", BINFHE_METHOD.LMKCDEY),
                         ("STD192", BINFHE_METHOD.AP),
                         ("STD192Q_LMKCDEY", BINFHE_METHOD.LMKCDEY)):
        with pytest.raises(ValueError, match="only GINX"):
            BinFHEContext(device="cpu").GenerateBinFHEContext(name, method)
        with pytest.raises(ValueError):
            JContext().GenerateBinFHEContext(name, method)
    with pytest.raises(ValueError, match="only GINX"):
        BinFHEContext(device="cpu").GenerateBinFHEContextCustom(
            **WIDE, method=BINFHE_METHOD.AP)
    small = BinFHEContext(seed=1, device="cpu").GenerateBinFHEContextCustom(
        **WIDE)
    with pytest.raises(ValueError, match="public-key"):
        small.BTKeyGen(small.KeyGen(), KEYGEN_MODE.PUB_ENCRYPT)
