"""The port's fused mult + relinearize chain against the JAX package.

One JAX context (N=2^13, 4 Q + 2 P towers of 26/27 bits, 2 digits: the
parameters of tests/test_torch_ckks.py, seed 11) makes the eval key, which
`convert` carries over; the ciphertext words come from a seeded numpy
generator. The JAX package's Pallas kernels of `ks_fused.py` run in
interpret mode, as tests/test_ks_fused.py runs them, and the port's plain
twins (what the CUDA kernels are held against on the card) get the same
inputs: every result must be word-equal. At level 1 the JAX package pads
its fused tables to a bucket and the port does not, so there the port's
chain is held against JAX's unfused `_k_mult_relin_hybrid`.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openfhe_tpu.pke import constants as jc  # noqa: E402
from openfhe_tpu.pke import context as jctx  # noqa: E402
from openfhe_tpu.pke import parameters as jprm  # noqa: E402
from openfhe_tpu.pke.keys import EvalKey as JEvalKey  # noqa: E402
from openfhe_tpu.pke.keyswitch import hybrid as jhybrid  # noqa: E402
from openfhe_tpu.pke.keyswitch import ks_fused as jks  # noqa: E402

from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch.lattice.basis import make_basis  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32, u32_tensor  # noqa: E402
from openfhe_tpu_torch.ops.modmatmul import _mod_matmul_rowmod_ref  # noqa
from openfhe_tpu_torch.pke import context as ctx  # noqa: E402
from openfhe_tpu_torch.pke.keys import EvalKey  # noqa: E402
from openfhe_tpu_torch.pke.keyswitch import hybrid, ks_fused  # noqa: E402

KW = dict(ring_dim=1 << 13, mult_depth=3, scaling_mod_size=26,
          first_mod_size=27, aux_mod_size=27, num_large_digits=2)


def _rand(rng, moduli, n, lead=()):
    q = np.array(moduli, np.uint64).reshape(-1, 1)
    v = rng.integers(0, 1 << 62, size=lead + (len(moduli), n),
                     dtype=np.uint64)
    return (v % q).astype(np.uint32)


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
    ek = cc.eval_mult_keys[kp.secret_key.key_tag]
    port_ek = convert.eval_key_from_numpy(
        np.asarray(ek.bv), np.asarray(ek.av), key_tag=ek.key_tag,
        device="cpu", bv_sh=np.asarray(ek.bv_sh),
        av_sh=np.asarray(ek.av_sh))
    return cc, ek, port_ek


def _port_tabs(cc, size_ql):
    basis = make_basis(list(cc.moduli_q[:size_ql]) + list(cc.moduli_p),
                       cc.ring_dim)
    return ks_fused.make_fused_ks_tables(basis, size_ql, len(cc.moduli_q),
                                         KW["num_large_digits"])


@pytest.fixture(scope="module")
def chain(jax_side):
    """At level 0: the inputs, every JAX kernel run one after the other on
    its predecessor's output, and JAX's mult_relin_fused, all in
    interpret mode. Returns numpy words."""
    cc, ek, _ = jax_side
    kq = len(cc.moduli_q)
    jt = jks.make_fused_ks_tables(cc.basis_q.moduli, cc.basis_p.moduli, kq,
                                  KW["num_large_digits"], cc.ring_dim, kq,
                                  pad_to=None)
    r, c, nd, kqlp = jt.r, jt.c, jt.nd, jt.kql + jt.kp
    rng = np.random.default_rng(7)
    a = [_rand(rng, cc.moduli_q, cc.ring_dim) for _ in range(4)]
    ja4 = [jnp.asarray(x).reshape(kq, r, c) for x in a]
    keys = [k.reshape(-1, k.shape[1], r, c)[:nd]
            for k in (ek.bv, ek.bv_sh, ek.av, ek.av_sh)]
    jks.INTERPRET = True
    try:
        c2, y = jks._tensor_intt(ja4[1], ja4[3], jt)
        y_pad = jks._pad_digits(y, jt)
        conv = jks._conv_digits(y_pad, jt)
        ext = jks._ntt_keymul_acc(conv.reshape(nd, kqlp, r, c), c2, *keys,
                                  jt)
        convq = jks._intt_conv_p(ext, jt)
        out = jks._ntt_submul_final(convq.reshape(2, kq, r, c), ext, *ja4,
                                    jt)
        p_coeff = jnp.asarray(_rand(rng, cc.moduli_p, cc.ring_dim, (2,)))
        conv_p = jks._conv_p_to_q(p_coeff, jt)
        fused = jks.mult_relin_fused(*(jnp.asarray(x) for x in a), ek.bv,
                                     ek.av, ek.bv_sh, ek.av_sh, jt)
    finally:
        jks.INTERPRET = False
    flat = lambda x, k: np.asarray(x).reshape(x.shape[:-3] + (k, -1))
    return dict(jt=jt, a=a, c2=flat(c2, kq), y=flat(y, kq),
                y_pad=np.asarray(y_pad), conv=np.asarray(conv),
                ext=flat(ext, kqlp), convq=np.asarray(convq),
                out=flat(out, kq), p_coeff=np.asarray(p_coeff),
                conv_p=np.asarray(conv_p),
                fused=[np.asarray(f) for f in fused])


def _eq(got, want):
    np.testing.assert_array_equal(to_u32(got), np.asarray(want))


def test_fused_tables_match_jax(jax_side, chain):
    cc, _, _ = jax_side
    jt, tt = chain["jt"], _port_tabs(cc, len(cc.moduli_q))
    assert (tt.kql, tt.kp, tt.nd, tt.alpha, tt.k_q_full) == (
        jt.kql, jt.kp, jt.nd, jt.alpha, jt.k_q_full)
    for name in ("bhatinv_q", "bhatinv_q_sh", "pscale", "pscale_sh",
                 "pinv_q", "pinv_q_sh"):
        _eq(getattr(tt, name)[:, 0], getattr(jt, name))
    # the conversion weights are the unfused chain's switch tables
    ht = hybrid.make_hybrid_tables(make_basis(cc.moduli_q, cc.ring_dim),
                                   make_basis(cc.moduli_p, cc.ring_dim),
                                   len(cc.moduli_q), KW["num_large_digits"])
    assert ht.fused is None                 # CPU tables: unfused only
    for j, part in enumerate(ht.parts):
        own = list(range(part.start, part.end))
        rest = [t for t in range(tt.kql + tt.kp) if t not in own]
        w = tt.conv_w[j, :len(own)]
        assert not w[:, own].any()
        assert torch.equal(w[:, rest], part.switch.bhat_mod_d)
        assert torch.equal(tt.conv_w_sh[j, :len(own)][:, rest],
                           part.switch.bhat_mod_d_sh)
        assert not tt.conv_w[j, len(own):].any()
    assert torch.equal(tt.pconv_w, ht.moddown.switch.bhat_mod_d)
    assert torch.equal(tt.pconv_w_sh, ht.moddown.switch.bhat_mod_d_sh)


def _twin_case(name, chain, tabs, ek):
    """(the port wrapper's CPU result, JAX's words) for one kernel."""
    t = lambda key: u32_tensor(chain[key])
    a0, a1, b0, b1 = (u32_tensor(x) for x in chain["a"])
    if name == "tensor_intt":
        c2, y = ks_fused.tensor_intt(a1, b1, tabs)
        return torch.stack([c2, y]), np.stack([chain["c2"], chain["y"]])
    if name == "conv_digits":
        return ks_fused.conv_digits(t("y"), tabs), chain["conv"]
    if name == "ntt_keymul_acc":
        return ks_fused.ntt_keymul_acc(t("conv"), t("c2"), ek.bv, ek.bv_sh,
                                       ek.av, ek.av_sh, tabs), chain["ext"]
    if name == "intt_conv_p":
        return ks_fused.intt_conv_p(t("ext"), tabs), chain["convq"]
    return (ks_fused.ntt_submul_final(t("convq"), t("ext"), a0, a1, b0, b1,
                                      tabs), chain["out"])


@pytest.mark.parametrize("name", ["tensor_intt", "conv_digits",
                                  "ntt_keymul_acc", "intt_conv_p",
                                  "ntt_submul_final"])
def test_plain_twin_matches_jax_kernel(jax_side, chain, name):
    """Each wrapper on CPU tensors (its plain twin) == the JAX Pallas
    kernel it replaces, on the kernel's own inputs in the chain."""
    cc, _, ek = jax_side
    got, want = _twin_case(name, chain, _port_tabs(cc, len(cc.moduli_q)),
                           ek)
    assert got.shape == want.shape
    _eq(got, want)


def test_conv_p_to_q_served_by_k45_conversion(jax_side, chain):
    """JAX's K5 `_conv_p_to_q` (no caller at HEAD) is the conversion half
    of the port's intt_conv_p: the rowmod with the K45 weights."""
    cc, _, _ = jax_side
    tabs = _port_tabs(cc, len(cc.moduli_q))
    got = _mod_matmul_rowmod_ref(u32_tensor(chain["p_coeff"]), tabs.pconv_w,
                                 tabs.basis_ql.q)
    _eq(got, chain["conv_p"])


@pytest.mark.parametrize("level", [0, 1])
def test_mult_relin_fused_matches_jax(jax_side, chain, level):
    """Level 0: == JAX's mult_relin_fused (interpret). Level 1 (3 Q
    towers, digits of 2 + 1): == JAX's unfused _k_mult_relin_hybrid."""
    cc, jek, ek = jax_side
    size_ql = len(cc.moduli_q) - level
    a = [x[:size_ql] for x in chain["a"]]
    got = ks_fused.mult_relin_fused(*(u32_tensor(x) for x in a), ek.bv,
                                    ek.av, ek.bv_sh, ek.av_sh,
                                    _port_tabs(cc, size_ql))
    if level == 0:
        want = chain["fused"]
    else:
        jtabs = cc.hybrid_tables(size_ql)
        assert jtabs.fused is None
        want = jctx._k_mult_relin_hybrid(*(jnp.asarray(x) for x in a), jek,
                                         jtabs)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("size_ql", [4, 3])
def test_mult_relin_hybrid_with_fused_tables(jax_side, size_ql):
    """The context's dispatch: fused tables attached on the CPU give the
    unfused chain's words; a key without companions is refused."""
    cc, _, ek = jax_side
    tabs = hybrid.make_hybrid_tables(make_basis(cc.moduli_q, cc.ring_dim),
                                     make_basis(cc.moduli_p, cc.ring_dim),
                                     size_ql, KW["num_large_digits"])
    fused = dataclasses.replace(tabs, fused=_port_tabs(cc, size_ql))
    rng = np.random.default_rng(size_ql)
    a = [u32_tensor(_rand(rng, cc.moduli_q[:size_ql], cc.ring_dim))
         for _ in range(4)]
    want = ctx.mult_relin_hybrid(*a, ek, tabs)
    got = ctx.mult_relin_hybrid(*a, ek, fused)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    bare = EvalKey(bv=ek.bv, av=ek.av, key_tag=ek.key_tag)
    with pytest.raises(ValueError, match="companions"):
        ctx.mult_relin_hybrid(*a, bare, fused)


def test_shoup_companions_match_jax(jax_side):
    """On the eval key (also as `convert` computes them), and on 27- and
    31-bit moduli including 2^31 - 1."""
    cc, jek, ek = jax_side
    moduli_qp = list(cc.moduli_q) + list(cc.moduli_p)
    got = hybrid.shoup_companions(EvalKey(bv=ek.bv, av=ek.av), moduli_qp)
    _eq(got.bv_sh, jek.bv_sh)
    _eq(got.av_sh, jek.av_sh)
    conv = convert.eval_key_from_numpy(np.asarray(jek.bv), np.asarray(jek.av),
                                       device="cpu", moduli_qp=moduli_qp)
    _eq(conv.bv_sh, jek.bv_sh)
    rng = np.random.default_rng(0)
    for mods in ([133160867, 133160831, 268435399],
                 [2147483647, 536870909]):
        v = _rand(rng, mods, 64, (2,))
        want = jhybrid.shoup_companions(
            JEvalKey(bv=jnp.asarray(v), av=jnp.asarray(v)), mods)
        got = hybrid.shoup_companions(
            EvalKey(bv=u32_tensor(v), av=u32_tensor(v)), mods)
        _eq(got.bv_sh, want.bv_sh)
        _eq(got.av_sh, want.av_sh)
