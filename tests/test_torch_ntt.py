"""The port's modular arithmetic, basis tables and NTT against the JAX package.

Inputs come from a seeded numpy generator and go to both packages; every
integer result must be word-equal (tolerance 0). On the CPU the port's
`ntt_fwd` / `ntt_inv` run their plain int64 versions, the ones the CUDA
kernels are held against on the card, and the JAX package runs
`_ntt_fwd_vpu` / `_ntt_inv_vpu`.
"""

import ast
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openfhe_tpu.lattice import basis as jbasis  # noqa: E402
from openfhe_tpu.math import modops as jmo  # noqa: E402
from openfhe_tpu.math import nbtheory  # noqa: E402
from openfhe_tpu.ops import ntt as jntt  # noqa: E402
from openfhe_tpu_torch.lattice.basis import make_basis  # noqa: E402
from openfhe_tpu_torch.math import modops as mo  # noqa: E402
from openfhe_tpu_torch.ops import modmatmul, ntt  # noqa: E402
from openfhe_tpu_torch.parallel import sharded_fused as sf  # noqa: E402
from openfhe_tpu_torch.pke.keys import EvalKey  # noqa: E402
from openfhe_tpu_torch.pke.keyswitch import hybrid, ks_fused  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VEC = os.path.join(ROOT, "tests", "vectors", "reference_vectors.json")


def _prime(bits, n=1024):
    return nbtheory.first_prime(bits, 2 * n)


def _rand(rng, moduli, n, lead=()):
    """Canonical uint32 residues [*lead, k, n]."""
    q = np.array(moduli, np.uint64).reshape((-1, 1))
    v = rng.integers(0, 1 << 62, size=lead + (len(moduli), n),
                     dtype=np.uint64)
    return (v % q).astype(np.uint32)


@pytest.mark.parametrize("bits", [26, 27, 31])
def test_modops_match_jax(bits):
    q = _prime(bits)
    assert q.bit_length() == bits
    assert mo.shoup(12345, q) == jmo.shoup(12345, q)
    assert mo.mod_constants(q) == jmo.mod_constants(q)
    rng = np.random.default_rng(bits)
    a, b, c = (_rand(rng, [q], 4096)[0] for _ in range(3))
    a[:4] = [0, q - 1, 0, 1]
    b[:4] = [0, q - 1, q - 1, q - 1]
    c_sh = ((c.astype(np.uint64) << np.uint64(32))
            // np.uint64(q)).astype(np.uint32)
    r32, r32_sh, m32 = jmo.mod_constants(q)
    ja, jb, jc, jq = (jnp.asarray(x) for x in (a, b, c, np.uint32(q)))
    ta, tb, tc, tsh = (mo.u32_tensor(x) for x in (a, b, c, c_sh))
    pairs = [
        (jmo.add_mod(ja, jb, jq), mo.add_mod(ta, tb, q)),
        (jmo.sub_mod(ja, jb, jq), mo.sub_mod(ta, tb, q)),
        (jmo.neg_mod(ja, jq), mo.neg_mod(ta, q)),
        (jmo.mul_mod(ja, jb, jq, np.uint32(r32), np.uint32(r32_sh),
                     np.uint32(m32)), mo.mul_mod(ta, tb, q)),
        (jmo.mul_mod_shoup(ja, jc, jnp.asarray(c_sh), jq),
         mo.mul_mod_shoup(ta, tc, tsh, q)),
    ]
    for want, got in pairs:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(mo.to_u32(got), np.asarray(want))


def test_make_basis_tables_match_jax():
    n = 1 << 10
    moduli = [_prime(26), _prime(27), _prime(31)]
    jb = jbasis.make_basis(moduli, n)
    tb = make_basis(moduli, n)
    assert tb.moduli == tuple(jb.moduli) and tb.ring_dim == n
    for name in ("q", "ninv", "ninv_sh", "psi_br", "psi_br_sh", "ipsi_br",
                 "ipsi_br_sh"):
        t = getattr(tb, name)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(mo.to_u32(t),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    sub = tb.slice(1, 3).concat(tb.slice(0, 1))
    assert sub.moduli == (moduli[1], moduli[2], moduli[0])
    np.testing.assert_array_equal(mo.to_u32(sub.psi_br[2]),
                                  np.asarray(jb.psi_br[0]))


@pytest.mark.parametrize("log_n", [10, 13])
def test_ntt_plain_matches_jax(log_n):
    n = 1 << log_n
    moduli = [_prime(26, n), _prime(27, n), _prime(31, n)]
    jb = jbasis.make_basis(moduli, n)
    tb = make_basis(moduli, n)
    rng = np.random.default_rng(log_n)
    x = _rand(rng, moduli, n, lead=(2,))
    fwd = ntt.ntt_fwd(mo.u32_tensor(x), tb)
    np.testing.assert_array_equal(
        mo.to_u32(fwd), np.asarray(jntt.ntt_fwd(jnp.asarray(x), jb)))
    inv = ntt.ntt_inv(mo.u32_tensor(x), tb)
    np.testing.assert_array_equal(
        mo.to_u32(inv), np.asarray(jntt.ntt_inv(jnp.asarray(x), jb)))
    np.testing.assert_array_equal(mo.to_u32(ntt.ntt_inv(fwd, tb)), x)


def test_ntt_golden_vectors():
    """Bit-exact against vectors dumped from the compiled reference, with
    the reference's roots (as tests/test_golden_vectors.py runs them)."""
    with open(VEC) as f:
        cases = json.load(f)["ntt"]
    for case in cases:
        n, q, root = case["n"], case["q"], case["root"]
        b = make_basis((q,), n, roots=(root,))
        x = mo.u32_tensor(np.array(case["x"], np.uint32)[None, :])
        got = mo.to_u32(ntt.ntt_fwd(x, b))[0]
        np.testing.assert_array_equal(got.astype(np.uint64),
                                      np.array(case["y_bitrev"], np.uint64),
                                      err_msg=f"N={n} q={q}")


def test_kernel_wrappers_take_no_fallback():
    """Off the CPU a wrapper launches its kernel or raises; a device
    without a kernel is refused, never computed by the plain version."""
    n = 1 << 10
    tb = make_basis([_prime(26)], n)
    x = torch.empty((1, n), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ntt.ntt_fwd(x, tb)
    with pytest.raises(ValueError, match="no kernel"):
        ntt.ntt_inv(x, tb)
    # both transforms of csrc/ntt.cu, the cluster and the staged one
    for fn in (ntt._ntt_fwd_cu, ntt._ntt_inv_cu, ntt._ntt_fwd_staged_cu,
               ntt._ntt_inv_staged_cu):
        with pytest.raises(ValueError, match="no kernel"):
            fn(x, tb)
    # the fused chains' seven wrappers and the four former forms, at 2 Q +
    # 1 P towers and 2 digits
    mods = [nbtheory.first_prime(b, 2 * n) for b in (26, 27, 28)]
    tabs = ks_fused.make_fused_ks_tables(make_basis(mods, n), 2, 2, 2)
    meta = lambda *shape: torch.empty(shape + (n,), dtype=torch.int32,
                                      device="meta")
    y_pad, ext = meta(2, 1), meta(2, 3)
    q_in, key = meta(2), meta(2, 3)
    calls = [
        ("tensor_intt", lambda: ks_fused.tensor_intt(q_in, q_in, tabs)),
        ("intt_scale", lambda: ks_fused.intt_scale(q_in, tabs)),
        ("intt_scale", lambda: ks_fused.intt_scale(ext, tabs, p_rows=True)),
        ("conv_digits", lambda: ks_fused.conv_digits(q_in, tabs)),
        ("ntt_keymul_acc", lambda: ks_fused.ntt_keymul_acc(
            meta(2, 3), q_in, key, key, key, key, tabs)),
        ("intt_conv_p", lambda: ks_fused.intt_conv_p(ext, tabs)),
        # the staged forms of K3 and K45
        ("ntt_keymul_acc_staged", lambda: ks_fused.ntt_keymul_acc_staged(
            meta(2, 3), q_in, key, key, key, key, tabs)),
        ("intt_conv_p_staged", lambda: ks_fused.intt_conv_p_staged(ext,
                                                                   tabs)),
        # the former forms of K6f and K2
        ("ntt_submul_final_staged", lambda: ks_fused.ntt_submul_final_staged(
            meta(2, 2), ext, q_in, q_in, q_in, q_in, tabs)),
        ("conv_digits_rowmod", lambda: ks_fused.conv_digits_rowmod(y_pad,
                                                                   tabs)),
        ("ntt_subscale", lambda: ks_fused.ntt_subscale(meta(2, 2), ext,
                                                       tabs)),
        ("ntt_submul_final", lambda: ks_fused.ntt_submul_final(
            meta(2, 2), ext, q_in, q_in, q_in, q_in, tabs)),
    ]
    # kernel l and the sharded chain's n, o, p, on shard 0 of 2 at 2 Q + 2 P
    mods.append(nbtheory.first_prime(29, 2 * n))
    ek = hybrid.shoup_companions(EvalKey(bv=torch.zeros(2, 4, n).int(),
                                         av=torch.zeros(2, 4, n).int()), mods)
    st = sf.make_sharded_fused_tables_basis(
        make_basis(mods[:2], n), make_basis(mods[2:], n), 2, 2, ek)
    view = sf.shard_view(st, 2, 0, "cpu")
    calls += [
        ("mod_matmul", lambda: modmatmul.mod_matmul(
            meta(2, 4)[..., :4], meta(2, 4)[..., :8], meta(2)[:, :1])),
        ("conv_digits_rows", lambda: sf.conv_digits_rows(y_pad, view)),
        ("conv_p_to_q_rows", lambda: sf.conv_p_to_q_rows(meta(2, 2), view)),
        ("ntt_keymul_acc_rows", lambda: sf.ntt_keymul_acc_rows(
            meta(2, 2), q_in, view)),
    ]
    for name, call in calls:
        with pytest.raises(ValueError, match=f"{name}: no kernel"):
            call()


_FORBIDDEN = ("jax", "jaxlib", "flax", "openfhe_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    """The port's package, its examples and chip_smoke.py import neither
    JAX nor the JAX package."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for top in ("openfhe_tpu_torch", "examples_torch"):
        for d, _, names in os.walk(os.path.join(ROOT, top)):
            files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    assert len(files) > 20
    assert any(os.sep + "parallel" + os.sep in f for f in files)
    assert sum(os.sep + "examples_torch" + os.sep in f for f in files) >= 5
    bad = [(os.path.relpath(f, ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in _FORBIDDEN]
    assert not bad, bad
