"""The port's general fused key switch (`keyswitch_core_fused`) against the
JAX package.

The JAX context of tests/test_torch_ks_fused.py (N=2^13, 4 Q + 2 P towers
of 26/27 bits, 2 digits, seed 11) makes the eval key, which `convert`
carries over; the inputs are words from a seeded numpy generator. JAX's
Pallas kernels run in interpret mode, as tests/test_ks_fused.py runs
them, and the port's plain twins of the CUDA kernels `intt_scale` and
`ntt_subscale` get the same inputs: every result must be word-equal, for
CKKS (t = 1) and with BGV's noise scale t = 65537 in the tables. At level
1 the JAX package would pad its fused tables to a bucket and the port does
not, so there the port's chain is held against JAX's unfused
`hybrid.keyswitch_core`.
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
from openfhe_tpu.pke.keyswitch import ks_fused as jks  # noqa: E402

from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch.lattice.basis import make_basis  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32, u32_tensor  # noqa: E402
from openfhe_tpu_torch.pke.keys import EvalKey  # noqa: E402
from openfhe_tpu_torch.pke.keyswitch import hybrid, ks_fused  # noqa: E402

KW = dict(ring_dim=1 << 13, mult_depth=3, scaling_mod_size=26,
          first_mod_size=27, aux_mod_size=27, num_large_digits=2)
T_BGV = 65537


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


def _jax_tabs(cc, size_ql, ns_int=1):
    kq = len(cc.moduli_q)
    return jks.make_fused_ks_tables(cc.basis_q.moduli, cc.basis_p.moduli,
                                    size_ql, KW["num_large_digits"],
                                    cc.ring_dim, kq, ns_int=ns_int,
                                    pad_to=None)


def _port_tabs(cc, size_ql, ns_int=1):
    basis = make_basis(list(cc.moduli_q[:size_ql]) + list(cc.moduli_p),
                       cc.ring_dim)
    return ks_fused.make_fused_ks_tables(basis, size_ql, len(cc.moduli_q),
                                         KW["num_large_digits"],
                                         ns_int=ns_int)


def _interpret(fn, *args):
    jks.INTERPRET = True
    try:
        return np.asarray(fn(*args))
    finally:
        jks.INTERPRET = False


def _eq(got, want):
    np.testing.assert_array_equal(to_u32(got), np.asarray(want))


@pytest.mark.parametrize("ns_int", [1, T_BGV])
def test_tables_match_jax(jax_side, ns_int):
    cc, _, _ = jax_side
    kq = len(cc.moduli_q)
    jt, tt = _jax_tabs(cc, kq, ns_int), _port_tabs(cc, kq, ns_int)
    assert tt.t_is_one == jt.t_is_one == (ns_int == 1)
    for name in ("pscale", "pscale_sh", "t_modq", "t_modq_sh", "pinv_q",
                 "pinv_q_sh", "bhatinv_q", "bhatinv_q_sh"):
        _eq(getattr(tt, name)[:, 0], getattr(jt, name))


@pytest.mark.parametrize("kql", [4, 3])
def test_intt_scale_matches_jax_pairs(jax_side, kql):
    """K1 against `_intt_scale_pairs`; at kql 3 JAX pads a garbage tower
    (read with P's first tables) and slices it off."""
    cc, _, _ = jax_side
    jt = _jax_tabs(cc, kql)
    c2 = _rand(np.random.default_rng(kql), cc.moduli_q[:kql], cc.ring_dim)
    want = _interpret(jks._intt_scale_pairs,
                      jnp.asarray(c2).reshape(kql, jt.r, jt.c), jt,
                      jt.bhatinv_q, jt.bhatinv_q_sh)
    got = ks_fused.intt_scale(u32_tensor(c2), _port_tabs(cc, kql))
    _eq(got, want.reshape(kql, -1))


@pytest.mark.parametrize("ns_int", [1, T_BGV])
def test_intt_scale_p_rows_matches_jax(jax_side, ns_int):
    """K4 against `_intt_scale(ext, tabs, kql, pscale, pscale_sh, k=kp,
    in_offset=kql)`: both elements' P rows of ext, read in place."""
    cc, _, _ = jax_side
    kq = len(cc.moduli_q)
    jt = _jax_tabs(cc, kq, ns_int)
    kqlp = kq + jt.kp
    ext = _rand(np.random.default_rng(5), list(cc.moduli_q)
                + list(cc.moduli_p), cc.ring_dim, (2,))
    want = _interpret(
        lambda x: jks._intt_scale(x, jt, kq, jt.pscale, jt.pscale_sh,
                                  k=jt.kp, in_offset=kq),
        jnp.asarray(ext).reshape(2, kqlp, jt.r, jt.c))
    got = ks_fused.intt_scale(u32_tensor(ext), _port_tabs(cc, kq, ns_int),
                              p_rows=True)
    _eq(got, want.reshape(2, jt.kp, -1))


@pytest.mark.parametrize("ns_int", [1, T_BGV])
def test_ntt_subscale_matches_jax(jax_side, ns_int):
    cc, _, _ = jax_side
    kq = len(cc.moduli_q)
    jt = _jax_tabs(cc, kq, ns_int)
    rng = np.random.default_rng(6)
    convq = _rand(rng, cc.moduli_q, cc.ring_dim, (2,))
    ext = _rand(rng, list(cc.moduli_q) + list(cc.moduli_p), cc.ring_dim,
                (2,))
    want = _interpret(jks._ntt_subscale,
                      jnp.asarray(convq).reshape(2, kq, jt.r, jt.c),
                      jnp.asarray(ext).reshape(2, kq + jt.kp, jt.r, jt.c),
                      jt)
    got = ks_fused.ntt_subscale(u32_tensor(convq), u32_tensor(ext),
                                _port_tabs(cc, kq, ns_int))
    _eq(got, want.reshape(2, kq, -1))


@pytest.mark.parametrize("ns_int", [1, T_BGV])
def test_keyswitch_core_fused_matches_jax(jax_side, ns_int):
    """Level 0: the whole chain against JAX's keyswitch_core_fused."""
    cc, jek, ek = jax_side
    kq = len(cc.moduli_q)
    c2 = _rand(np.random.default_rng(8), cc.moduli_q, cc.ring_dim)
    jt = _jax_tabs(cc, kq, ns_int)
    jks.INTERPRET = True
    try:
        want = jks.keyswitch_core_fused(jnp.asarray(c2), jek.bv, jek.av,
                                        jek.bv_sh, jek.av_sh, jt)
    finally:
        jks.INTERPRET = False
    got = ks_fused.keyswitch_core_fused(u32_tensor(c2), ek.bv, ek.av,
                                        ek.bv_sh, ek.av_sh,
                                        _port_tabs(cc, kq, ns_int))
    for g, w in zip(got, want):
        _eq(g, w)


def test_keyswitch_core_fused_level1_matches_jax_unfused(jax_side):
    """Level 1 (3 Q towers, digits of 2 + 1), against JAX's unfused
    chain."""
    cc, jek, ek = jax_side
    c2 = _rand(np.random.default_rng(9), cc.moduli_q[:3], cc.ring_dim)
    jtabs = cc.hybrid_tables(3)
    assert jtabs.fused is None
    want = jhybrid.keyswitch_core(jnp.asarray(c2), jek, jtabs)
    got = ks_fused.keyswitch_core_fused(u32_tensor(c2), ek.bv, ek.av,
                                        ek.bv_sh, ek.av_sh,
                                        _port_tabs(cc, 3))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("size_ql", [4, 3])
def test_keyswitch_core_dispatch(jax_side, size_ql):
    """`hybrid.keyswitch_core` with fused tables attached on the CPU gives
    the unfused chain's words; a key without companions is refused."""
    cc, _, ek = jax_side
    tabs = hybrid.make_hybrid_tables(make_basis(cc.moduli_q, cc.ring_dim),
                                     make_basis(cc.moduli_p, cc.ring_dim),
                                     size_ql, KW["num_large_digits"])
    fused = dataclasses.replace(tabs, fused=_port_tabs(cc, size_ql))
    c2 = u32_tensor(_rand(np.random.default_rng(size_ql),
                          cc.moduli_q[:size_ql], cc.ring_dim))
    want = hybrid.keyswitch_core(c2, ek, tabs)
    got = hybrid.keyswitch_core(c2, ek, fused)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    bare = EvalKey(bv=ek.bv, av=ek.av, key_tag=ek.key_tag)
    with pytest.raises(ValueError, match="companions"):
        hybrid.keyswitch_core(c2, bare, fused)
