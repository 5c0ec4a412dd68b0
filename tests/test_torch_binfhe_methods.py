"""AP, LMKCDEY and the functional bootstraps of the port against JAX.

The second half of `test_torch_binfhe.py`, whose helpers it shares: each
test makes a JAX context with its keys, carries the keys and the JAX-made
ciphertexts into a port context on the CPU with `openfhe_tpu_torch.convert`,
and requires the JAX package's output words exactly (tolerance 0), with
the JAX device mod switch replaced by its exact formula (see there).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openfhe_tpu.binfhe.constants import BINFHE_METHOD as JMETHOD  # noqa: E402
from openfhe_tpu.binfhe.constants import BINGATE as JGATE  # noqa: E402
from openfhe_tpu_torch.binfhe import lwe, rgsw  # noqa: E402
from openfhe_tpu_torch.binfhe.constants import BINFHE_METHOD, BINGATE  # noqa: E402
from openfhe_tpu_torch.binfhe.context import BinFHEContext  # noqa: E402
from openfhe_tpu_torch.math.modops import u32_tensor  # noqa: E402
from test_torch_binfhe import (M1, M2, _jax_exact_mod_switch,  # noqa: E402,F401
                               _pair, _port_ct, _same)

FUNC = dict(n=64, N=1024, q=1024, q_bits=27, base_ks=25, base_g=512)


@pytest.fixture(scope="module")
def func_ctx():
    return _pair(lambda c: c.GenerateBinFHEContextCustom(**FUNC),
                 lambda c: c.GenerateBinFHEContextCustom(**FUNC))


def test_ap_words():
    jcc, jsk, cc, sk = _pair(
        lambda c: c.GenerateBinFHEContext("TOY", JMETHOD.AP),
        lambda c: c.GenerateBinFHEContext("TOY", BINFHE_METHOD.AP))
    jc1 = jcc.Encrypt(jsk, jnp.array([0, 1], jnp.uint32))
    jc2 = jcc.Encrypt(jsk, jnp.array([1, 1], jnp.uint32))
    out = cc.EvalBinGate(BINGATE.AND, _port_ct(jc1), _port_ct(jc2))
    _same(out, jcc.EvalBinGate(JGATE.AND, jc1, jc2))
    np.testing.assert_array_equal(cc.Decrypt(sk, out), [0, 1])


LMK_SHAPES = [dict(n=64, N=1024, q=2048, q_bits=27, base_ks=25, base_g=128),
              dict(n=16, N=256, q=128, q_bits=27, base_ks=25, base_g=512)]


@pytest.mark.parametrize("shape", LMK_SHAPES, ids=["q=2N", "q=N/2"])
def test_lmkcdey_words(shape):
    jcc, jsk, cc, sk = _pair(
        lambda c: c.GenerateBinFHEContextCustom(
            **shape, method=JMETHOD.LMKCDEY, num_auto_keys=10),
        lambda c: c.GenerateBinFHEContextCustom(
            **shape, method=BINFHE_METHOD.LMKCDEY, num_auto_keys=10))
    jc1, jc2 = (jcc.Encrypt(jsk, jnp.asarray(m, jnp.uint32))
                for m in (M1, M2))
    out = cc.EvalBinGate(BINGATE.AND, _port_ct(jc1), _port_ct(jc2))
    _same(out, jcc.EvalBinGate(JGATE.AND, jc1, jc2))
    np.testing.assert_array_equal(cc.Decrypt(sk, out), M1 & M2)


def test_lmkcdey_loop_matches_host_schedule():
    """The batched schedule loop equals the reference's host loop
    (eval_acc_lmkcdey) on port-made keys, at a q != 2N shape."""
    cc = BinFHEContext(seed=5, device="cpu").GenerateBinFHEContextCustom(
        n=12, N=128, q=64, q_bits=27, base_ks=25, base_g=512,
        method=BINFHE_METHOD.LMKCDEY, num_auto_keys=6)
    params = cc.rgsw
    sk_n_eval = rgsw._fwd1(torch.remainder(
        lwe.key_gen(cc.gen, cc.N).s.long(), cc.Q), params.basis)
    s = lwe.key_gen(cc.gen, cc.n).s
    rgsw_keys = rgsw.keygen_rgsw_monomial(cc.gen, params, sk_n_eval,
                                          s.tolist())
    m = 2 * cc.N
    auto = {j: rgsw.keygen_auto(cc.gen, params, sk_n_eval,
                                m - 5 if j == 0 else pow(5, j, m))
            for j in range(7)}
    bank = rgsw.lmkcdey_key_bank(params, rgsw_keys, auto, 6)
    perm = torch.from_numpy(rgsw.lmkcdey_perm_table(params, 6))
    rng = np.random.default_rng(11)
    a_vec = rng.integers(0, cc.q, size=cc.n)
    acc0 = torch.zeros(cc.N, dtype=torch.int32)
    acc1 = u32_tensor(rng.integers(0, cc.Q, size=cc.N))
    ref = rgsw.eval_acc_lmkcdey(params, rgsw_keys, auto, 6, acc0, acc1,
                                a_vec)
    sched = torch.from_numpy(rgsw.build_lmkcdey_schedule(params, a_vec, 6))
    got = rgsw.eval_acc_lmkcdey_scan(params, bank, perm, sched, acc0, acc1)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_eval_func_words(func_ctx):
    jcc, jsk, cc, sk = func_ctx
    p = 4
    jct = jcc.Encrypt(jsk, jnp.arange(p, dtype=jnp.uint32), p=p)
    for f, want in ((lambda m, pp: (m * m) % pp, np.arange(p) ** 2 % p),
                    (lambda m, pp: m // 2, np.arange(p) // 2)):
        lut = cc.GenerateLUTviaFunction(f, p)
        np.testing.assert_array_equal(lut, jcc.GenerateLUTviaFunction(f, p))
        out = cc.EvalFunc(_port_ct(jct), lut)
        _same(out, jcc.EvalFunc(jct, lut))
        np.testing.assert_array_equal(cc.Decrypt(sk, out, p=p), want)


def test_eval_floor_sign_decomp_words(func_ctx):
    """At mod 2^12 (one floor round) to keep the JAX side short."""
    jcc, jsk, cc, sk = func_ctx
    mod = 1 << 12
    jct = jcc.Encrypt(jsk, jnp.array([2, 1500], jnp.uint32), p=mod // 2,
                      q=mod)
    ct = _port_ct(jct)
    _same(cc.EvalFloor(ct), jcc.EvalFloor(jct))
    out = cc.EvalSign(ct)
    _same(out, jcc.EvalSign(jct))
    np.testing.assert_array_equal(cc.Decrypt(sk, out, p=2), [0, 1])
    digits = cc.EvalDecomp(ct)
    jdigits = jcc.EvalDecomp(jct)
    assert len(digits) == len(jdigits) == 2
    for d, jd in zip(digits, jdigits):
        _same(d, jd)
