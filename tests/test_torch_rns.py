"""The port's base conversion and RNS tools against the JAX package.

Moduli are those of the CKKS context of tests/test_torch_ckks.py (N=2^13,
4 Q towers of 26/27 bits, 2 P towers). On the CPU the port's
`mod_matmul_rowmod` runs its plain int64 version and the JAX package
runs `mod_matmul_rowmod_jnp`; results must be word-equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openfhe_tpu.lattice import basis as jbasis  # noqa: E402
from openfhe_tpu.lattice import dcrt as jdcrt  # noqa: E402
from openfhe_tpu.lattice import rns_tools as jrt  # noqa: E402
from openfhe_tpu_torch.lattice import rns_tools as rt  # noqa: E402
from openfhe_tpu_torch.lattice.basis import make_basis  # noqa: E402
from openfhe_tpu_torch.lattice.dcrt import COEFF, EVAL, Poly  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32, u32_tensor  # noqa: E402
from openfhe_tpu_torch.ops.modmatmul import mod_matmul_rowmod  # noqa: E402
from openfhe_tpu_torch.pke import parameters as prm  # noqa: E402

N = 1 << 13


@pytest.fixture(scope="module")
def bases():
    q = prm.select_ckks_moduli(N, 3, 26, 27, flexible=False)
    p = prm.select_aux_moduli(N, q, 2, 27)
    assert (len(q), len(p)) == (4, 2)
    return (q, p, jbasis.make_basis(q, N), jbasis.make_basis(p, N),
            make_basis(q, N), make_basis(p, N))


def _rand(rng, moduli, lead=()):
    q = np.array(moduli, np.uint64).reshape((-1, 1))
    v = rng.integers(0, 1 << 62, size=lead + (len(moduli), N),
                     dtype=np.uint64)
    return (v % q).astype(np.uint32)


@pytest.mark.parametrize("split", [(0, 2), (2, 4), (1, 4), (3, 4)])
def test_switch_crt_basis_approx_matches_jax(bases, split):
    """Digit -> complement conversions of the hybrid key switch, and the
    conversion kernel's plain version on its own."""
    q, p, _, _, tq, tp = bases
    s, e = split
    from_m = q[s:e]
    to_m = q[:s] + q[e:] + p
    jtab = jrt.make_switch_tables(from_m, to_m)
    tab = rt.make_switch_tables(from_m, to_m)
    np.testing.assert_array_equal(to_u32(tab.bhat_mod_d),
                                  np.asarray(jtab.bhat_mod_d)[:, :, 0])
    np.testing.assert_array_equal(to_u32(tab.bhat_mod_d_sh),
                                  np.asarray(jtab.bhat_mod_d_sh)[:, :, 0])
    rng = np.random.default_rng(s * 10 + e)
    x = _rand(rng, from_m, lead=(2,))
    jin = jbasis.make_basis(from_m, N)
    jout = jbasis.make_basis(to_m, N)
    tin = tq.slice(s, e)
    tout = tq.slice(0, s).concat(tq.slice(e, len(q))).concat(tp)
    want = np.asarray(jrt.switch_crt_basis_approx(jnp.asarray(x), jin, jout,
                                                  jtab))
    got = rt.switch_crt_basis_approx(u32_tensor(x), tin, tout, tab)
    np.testing.assert_array_equal(to_u32(got), want)
    # the contraction alone, from the same pre-multiplied inputs
    y = _rand(rng, from_m)
    want = np.asarray(jrt._accumulate_converted(jnp.asarray(y), jtab, jout))
    got = mod_matmul_rowmod(u32_tensor(y), tab.bhat_mod_d, tab.bhat_mod_d_sh,
                            tout.q, tout.red64)
    np.testing.assert_array_equal(to_u32(got), want)


@pytest.mark.parametrize("fmt", [EVAL, COEFF])
def test_approx_mod_down_matches_jax(bases, fmt):
    q, p, jq, jp, tq, tp = bases
    jtab = jrt.make_mod_down_tables(p, q)
    tab = rt.make_mod_down_tables(p, q)
    rng = np.random.default_rng(fmt)
    xq, xp = _rand(rng, q), _rand(rng, p)
    want = jrt.approx_mod_down(jnp.asarray(xq), jnp.asarray(xp), jq, jp,
                               jtab, fmt=fmt)
    got = rt.approx_mod_down(u32_tensor(xq), u32_tensor(xp), tq, tp, tab,
                             fmt=fmt)
    np.testing.assert_array_equal(to_u32(got), np.asarray(want))


@pytest.mark.parametrize("size,fmt", [(4, EVAL), (3, EVAL), (4, COEFF)])
def test_drop_last_and_scale_matches_jax(bases, size, fmt):
    q, _, jq, _, tq, _ = bases
    jtab = jrt.make_drop_scale_tables(tuple(q[:size]))
    tab = rt.make_drop_scale_tables(tuple(q[:size]))
    rng = np.random.default_rng(size + 10 * fmt)
    x = _rand(rng, q[:size])
    want = jrt.drop_last_and_scale(jdcrt.Poly(jnp.asarray(x), fmt),
                                   jq.slice(0, size), jtab)
    got = rt.drop_last_and_scale(Poly(u32_tensor(x), fmt),
                                 tq.slice(0, size), tab)
    assert got.fmt == fmt and got.data.shape == (size - 1, N)
    np.testing.assert_array_equal(to_u32(got.data), np.asarray(want.data))
