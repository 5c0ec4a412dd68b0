"""The port's BinFHE (`openfhe_tpu_torch/binfhe/`) against the JAX package.

Keys are random and the two packages' generators never agree, so each
module fixture makes a JAX context with its keys once and carries the keys
(and the JAX-made input ciphertexts) into a port context on the CPU with
`openfhe_tpu_torch.convert`. Every op must then return the JAX package's
output words exactly (tolerance 0). On the CPU the port's NTT calls run
the plain stage loop; on the card the same calls are kernel m, which
`chip_smoke.py` holds against its plain version. The last tests run the
port alone: its own keygen, then gates that must decrypt correctly.
GINX at TOY and the LWE layer are here; AP, LMKCDEY and the functional
bootstraps are in `test_torch_binfhe_methods.py`, which shares these
helpers.

One fault of the JAX package is corrected on its side first: its device
mod switch (`lwe.mod_switch_device`, a float32 quotient estimate with three
correction steps) is exact only while v * q_to stays near 2^43, so the
switch from Q to qKS = Q of TOY and of every custom context (about 2^54)
moves some words by a few units (ROADMAP queue 3). The port computes the
exact rounding, so the JAX side runs with the exact formula of its own
host path in place of the device one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openfhe_tpu.binfhe import lwe as jlwe  # noqa: E402
from openfhe_tpu.binfhe import rgsw as jrgsw  # noqa: E402
from openfhe_tpu.binfhe.constants import BINGATE as JGATE  # noqa: E402
from openfhe_tpu.binfhe.context import BinFHEContext as JContext  # noqa: E402
from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch.binfhe import lwe, rgsw  # noqa: E402
from openfhe_tpu_torch.binfhe.constants import BINFHE_METHOD, BINGATE  # noqa: E402
from openfhe_tpu_torch.binfhe.context import BinFHEContext  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32, u32_tensor  # noqa: E402

real_mod_switch_device = jlwe.mod_switch_device
M1 = np.array([0, 0, 1, 1])
M2 = np.array([0, 1, 0, 1])
M3 = np.array([0, 1, 1, 1])


def _exact_mod_switch(q_to, jct):
    """The JAX package's mod switch with its exact int64 formula."""
    q_from = int(jct.modulus)
    rq = lambda v: jnp.asarray(
        ((np.asarray(v).astype(np.int64) * q_to + q_from // 2) // q_from
         % q_to).astype(np.uint32))
    return jct.replace(a=rq(jct.a), b=rq(jct.b), modulus=q_to)


@pytest.fixture(scope="module", autouse=True)
def _jax_exact_mod_switch():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlwe, "mod_switch_device", _exact_mod_switch)
        yield


def _port_ct(jct):
    return convert.lwe_ciphertext_from_numpy(
        np.asarray(jct.a), np.asarray(jct.b), jct.modulus, jct.pt_modulus,
        device="cpu")


def _same(ct, jct):
    assert (ct.modulus, ct.pt_modulus) == (jct.modulus, jct.pt_modulus)
    np.testing.assert_array_equal(to_u32(ct.a), np.asarray(jct.a))
    np.testing.assert_array_equal(to_u32(ct.b), np.asarray(jct.b))


def _pair(make_jax, make_port):
    """A JAX context with keys, and a port context on the CPU with the
    same ring and the JAX keys."""
    jcc = make_jax(JContext(seed=3))
    jsk = jcc.KeyGen()
    jcc.BTKeyGen(jsk)
    cc = make_port(BinFHEContext(seed=3, device="cpu"))
    assert (cc.n, cc.N, cc.q, cc.Q, cc.q_ks) == (jcc.n, jcc.N, jcc.q, jcc.Q,
                                                 jcc.q_ks)
    ks = jcc.ks_key
    cc.ks_key = convert.switching_key_from_numpy(
        np.asarray(ks.a), np.asarray(ks.b), ks.mod_ks, ks.base_ks,
        device="cpu")
    cc.bt_key = convert.bt_key_from_numpy(jcc.method, jcc.bt_key, "cpu")
    sk = convert.lwe_secret_from_numpy(np.asarray(jsk.s), device="cpu")
    return jcc, jsk, cc, sk


@pytest.fixture(scope="module")
def toy():
    jcc, jsk, cc, sk = _pair(lambda c: c.GenerateBinFHEContext("TOY"),
                             lambda c: c.GenerateBinFHEContext("TOY"))
    jcts = [jcc.Encrypt(jsk, jnp.asarray(m, jnp.uint32)) for m in (M1, M2,
                                                                     M3)]
    return jcc, jsk, cc, sk, jcts, [_port_ct(c) for c in jcts]


GATES = [("AND", lambda a, b: a & b), ("OR", lambda a, b: a | b),
         ("NAND", lambda a, b: 1 - (a & b)), ("XOR", lambda a, b: a ^ b),
         ("XNOR", lambda a, b: 1 - (a ^ b))]


@pytest.mark.parametrize("gate,fn", GATES, ids=[g for g, _ in GATES])
def test_bin_gate_words(toy, gate, fn):
    jcc, jsk, cc, sk, jcts, cts = toy
    jout = jcc.EvalBinGate(JGATE[gate], jcts[0], jcts[1])
    out = cc.EvalBinGate(BINGATE[gate], cts[0], cts[1])
    _same(out, jout)
    np.testing.assert_array_equal(cc.Decrypt(sk, out), fn(M1, M2))


def test_not_bootstrap_words(toy):
    jcc, jsk, cc, sk, jcts, cts = toy
    _same(cc.EvalNOT(cts[0]), jcc.EvalNOT(jcts[0]))
    out = cc.Bootstrap(cts[0])
    _same(out, jcc.Bootstrap(jcts[0]))
    np.testing.assert_array_equal(cc.Decrypt(sk, out), M1)
    const = cc.EvalConstant(np.array([0, 1]))
    _same(const, jcc.EvalConstant(jnp.asarray([0, 1], jnp.uint32)))


def test_three_input_gates_words(toy):
    """AND3 and OR3 on p = 6 encryptions (three bits sum to 3), MAJORITY
    on the p = 4 ones."""
    jcc, jsk, cc, sk, jcts, cts = toy
    jcts6 = [jcc.Encrypt(jsk, jnp.asarray(m, jnp.uint32), p=6)
             for m in (M1, M2, M3)]
    for gate, want, js in (("AND3", M1 & M2 & M3, jcts6),
                           ("OR3", M1 | M2 | M3, jcts6),
                           ("MAJORITY", (M1 + M2 + M3 >= 2) * 1, jcts)):
        jout = jcc.EvalBinGate(JGATE[gate], list(js))
        out = cc.EvalBinGate(BINGATE[gate], [_port_ct(c) for c in js])
        _same(out, jout)
        np.testing.assert_array_equal(cc.Decrypt(sk, out), want)


def test_cmux_words(toy):
    jcc, jsk, cc, sk, jcts, cts = toy
    out = cc.EvalCMUX(cts[0], cts[1], cts[2])
    _same(out, jcc.EvalCMUX(jcts[0], jcts[1], jcts[2]))
    np.testing.assert_array_equal(cc.Decrypt(sk, out),
                                  np.where(M3, M2, M1))


@pytest.mark.parametrize("qf,qt", [(134215681, 32768), (134215681, 1024),
                                   (32768, 1024), (268369921, 2048),
                                   (12289, 512)])
def test_mod_switch_words(qf, qt):
    rng = np.random.default_rng(0)
    x = rng.integers(0, qf, size=4096, dtype=np.int64)
    x[:5] = [0, 1, qf - 1, qf // 2, qf // 2 + 1]
    jct = jlwe.LWECiphertext(a=jnp.asarray(x.astype(np.uint32)),
                             b=jnp.asarray(x[:1].astype(np.uint32)),
                             modulus=qf, pt_modulus=4)
    with pytest.MonkeyPatch.context() as mp:   # the JAX device path itself
        mp.setattr(jlwe, "mod_switch_device", real_mod_switch_device)
        _same(lwe.mod_switch(qt, _port_ct(jct)), jlwe.mod_switch(qt, jct))
    want = ((x * qt * 2 + qf) // (2 * qf)) % qt
    np.testing.assert_array_equal(
        to_u32(lwe.mod_switch(qt, _port_ct(jct)).a), want)


@pytest.mark.parametrize("qf,qt", [(134215681, 134215681),
                                   (268369921, 268369921),
                                   (32768, 134215681)])
def test_mod_switch_exact_at_wide_numerators(qf, qt):
    """Where v * q_to reaches 2^54 the port still rounds exactly (the JAX
    device path does not: ROADMAP queue 3)."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, qf, size=4096, dtype=np.int64)
    x[:4] = [0, 1, qf - 1, qf // 2]
    ct = lwe.LWECiphertext(a=u32_tensor(x), b=u32_tensor(x[:2]),
                           modulus=qf)
    np.testing.assert_array_equal(to_u32(lwe.mod_switch(qt, ct).a),
                                  ((x * qt * 2 + qf) // (2 * qf)) % qt)


def test_signed_digit_decompose_words(toy):
    """Digits >= B/2 (where int32 and int64 sign extension part) and the
    edge residues, against JAX; the digits rebuild the centred value up to
    the dropped first digit."""
    jcc, _, cc, _, _, _ = toy
    params, q, base = cc.rgsw, cc.Q, cc.rgsw.base_g
    rng = np.random.default_rng(1)
    x = rng.integers(0, q, size=(2, 1024), dtype=np.int64)
    edge = [0, 1, q - 1, q // 2, q // 2 - 1, q // 2 + 1, base // 2,
            base - 1, q - base // 2]
    edge += [(base // 2) * base ** k for k in range(1, 3)]
    edge += [(base - 1) * base ** k + base // 2 for k in range(1, 3)]
    x[0, :len(edge)] = edge
    x[1, :len(edge)] = [(q - v) % q for v in edge]
    got = to_u32(rgsw.signed_digit_decompose(
        params, u32_tensor(x[0]), u32_tensor(x[1])))
    want = np.asarray(jrgsw.signed_digit_decompose(
        jcc.rgsw, jnp.asarray(x[0].astype(np.uint32)),
        jnp.asarray(x[1].astype(np.uint32))))
    np.testing.assert_array_equal(got, want)
    got = got.astype(np.int64)
    signed = np.where(got > q // 2, got - q, got)
    assert (np.abs(signed) >= base // 2).any()
    # c = r0 + B * d with r0 the dropped digit, and the digits give d mod
    # B^(digitsG - 1): rebuilt = c - r0 mod B^digitsG
    rebuilt = sum(signed[2 * j:2 * j + 2] * base ** (j + 1)
                  for j in range(params.digits_g - 1))
    span = base ** params.digits_g
    diff = (rebuilt - np.where(x >= q // 2, x - q, x)) % span
    assert np.abs(np.where(diff > span // 2, diff - span, diff)).max() \
        <= base // 2
    one = to_u32(rgsw.signed_digit_decompose_one(params, u32_tensor(x[0])))
    np.testing.assert_array_equal(one, want[0::2])


def test_key_switch_test_vector_and_one_step_words(toy):
    jcc, jsk, cc, sk, jcts, cts = toy
    # key switch of an (N, Q) sample: the extracted accumulator's shape
    rng = np.random.default_rng(2)
    a = rng.integers(0, jcc.Q, size=(3, jcc.N), dtype=np.int64)
    b = rng.integers(0, jcc.Q, size=(3,), dtype=np.int64)
    jct = jlwe.LWECiphertext(a=jnp.asarray(a.astype(np.uint32)),
                             b=jnp.asarray(b.astype(np.uint32)),
                             modulus=jcc.Q, pt_modulus=4)
    jms = jlwe.mod_switch(jcc.ks_key.mod_ks, jct)
    _same(lwe.key_switch(cc.ks_key, _port_ct(jms)),
          jlwe.key_switch(jcc.ks_key, jms))
    _same(lwe.switch_ct_to_qn(cc.ks_key, cc.q, _port_ct(jct)),
          jlwe.switch_ct_to_qn(jcc.ks_key, jcc.q, jct))
    # test vectors of every gate constant
    bq = rng.integers(0, jcc.q, size=(4,))
    for gate in ("AND", "XOR", "AND3"):
        np.testing.assert_array_equal(
            to_u32(cc._test_vector(u32_tensor(bq), BINGATE[gate])),
            np.asarray(jcc._test_vector(jnp.asarray(bq.astype(np.uint32)),
                                        JGATE[gate])))
    # one GINX step on random accumulators
    acc = rng.integers(0, jcc.Q, size=(2, 4, jcc.N), dtype=np.int64)
    a_lwe = rng.integers(0, jcc.q, size=(4, 1), dtype=np.int64)
    j0, j1 = jrgsw.eval_acc_cggi(
        jcc.rgsw, jcc.bt_key[:1], *(jnp.asarray(v.astype(np.uint32))
                                    for v in (acc[0], acc[1], a_lwe)))
    p0, p1 = rgsw.eval_acc_cggi(cc.rgsw, cc.bt_key[:1],
                                *(u32_tensor(v) for v in (acc[0], acc[1],
                                                          a_lwe)))
    np.testing.assert_array_equal(to_u32(p0), np.asarray(j0))
    np.testing.assert_array_equal(to_u32(p1), np.asarray(j1))


def test_public_key_path_words():
    """JAX's public key carried over: the port's encryption decrypts,
    and JAX-made (N, Q) ciphertexts switch down and gate to JAX's words."""
    jcc = JContext(seed=4).GenerateBinFHEContext("TOY")
    jsk = jcc.KeyGen()
    jpk, jsk_n = jcc.KeyGenPair()
    jcc.BTKeyGen(jsk)
    cc = BinFHEContext(seed=4, device="cpu").GenerateBinFHEContext("TOY")
    cc.ks_key = convert.switching_key_from_numpy(
        np.asarray(jcc.ks_key.a), np.asarray(jcc.ks_key.b),
        jcc.ks_key.mod_ks, jcc.ks_key.base_ks, device="cpu")
    cc.bt_key = convert.bt_key_from_numpy(jcc.method, jcc.bt_key, "cpu")
    sk = convert.lwe_secret_from_numpy(np.asarray(jsk.s), device="cpu")
    sk_n = convert.lwe_secret_from_numpy(np.asarray(jsk_n.s), device="cpu")
    pk = convert.lwe_public_key_from_numpy(np.asarray(jpk.A),
                                           np.asarray(jpk.v), device="cpu")
    bits = np.array([0, 1, 1, 0])
    np.testing.assert_array_equal(cc.Decrypt(sk, cc.Encrypt(pk, bits)), bits)
    np.testing.assert_array_equal(
        lwe.decrypt(sk_n, cc.Encrypt(pk, bits, output="LARGE_DIM")), bits)
    ja, jb = (jcc.Encrypt(jpk, jnp.asarray(m, jnp.uint32),
                          output="LARGE_DIM") for m in (M1, M2))
    _same(lwe.switch_ct_to_qn(cc.ks_key, cc.q, _port_ct(ja)),
          jlwe.switch_ct_to_qn(jcc.ks_key, jcc.q, ja))
    out = cc.EvalBinGate(BINGATE.AND, _port_ct(ja), _port_ct(jb))
    _same(out, jcc.EvalBinGate(JGATE.AND, ja, jb))
    np.testing.assert_array_equal(cc.Decrypt(sk, out), M1 & M2)


def test_port_keygen_round_trip():
    """The port alone: its own keys (secret and public), gates decrypt."""
    cc = BinFHEContext(seed=9, device="cpu").GenerateBinFHEContext("TOY")
    sk = cc.KeyGen()
    pk, _ = cc.KeyGenPair()
    cc.BTKeyGen(sk)
    c1, c2 = cc.Encrypt(sk, M1), cc.Encrypt(pk, M2)
    for gate, fn in GATES:
        np.testing.assert_array_equal(
            cc.Decrypt(sk, cc.EvalBinGate(BINGATE[gate], c1, c2)),
            fn(M1, M2))
    np.testing.assert_array_equal(cc.Decrypt(sk, cc.EvalNOT(c1)), 1 - M1)


def test_context_defaults_and_wide_sets():
    """Without a device the context asks for the card (and raises here
    without one); composite-Q sets build on their 2-tower ring
    (`test_torch_binfhe_wide.py` holds it against JAX) for GINX only."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BinFHEContext()
    cc = BinFHEContext(device="cpu").GenerateBinFHEContext("STD192")
    assert cc.wide and cc.rgsw is None and cc.Q.bit_length() > 31
    with pytest.raises(ValueError, match="only GINX"):
        BinFHEContext(device="cpu").GenerateBinFHEContext(
            "STD192_LMKCDEY", BINFHE_METHOD.LMKCDEY)
