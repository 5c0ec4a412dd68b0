"""Kernels p, n and o of the limb-sharded key switch on their new
schedules, on the CPU.

`csrc/sharded.cu` runs `ntt_keymul_acc_rows` (p) as one launch of K3's
`keymul_cluster` (csrc/keymul_cluster.cuh) over a shard's rows, local row
tau being global row tau0 + tau, own below own_end (the level's real Q
towers); `conv_digits_rows` (n) as one launch of K2's `pconv`
(csrc/pconv_core.cuh) reading the gathered y [kql, N] in place, with the
shard's weight columns, output row j being global row d_off + j (d_off =
tau0) and the own rows below own_end written as zeros; and
`conv_p_to_q_rows` (o) as one launch of K45's `pconv` over both elements
of pc [2, kp, N] (batch 2, one table: w_stride 0, no own rows) with the
shard's P -> Q weight columns and its Q rows' `Basis.red64`. There is no
card here, so the schedules run through the numpy models of
tests/test_torch_ks_cluster.py (`model_keymul` with tau0 and own_end,
`model_pconv` with d_off and own_end; with tau0 = 0 they are K3's and
K2's, which that file and tests/test_torch_ks_final.py hold), with the
launches' arguments, and are held word for word (tolerance 0) against
JAX's Pallas kernels `_ntt_keymul_acc_sharded`, `_conv_digits_rows` and
`_conv_p_to_q_rows` (interpret mode, on their shards' slices of JAX's
tables, as tests/test_torch_parallel.py runs them) and against the port's
plain twins, in the context of tests/test_torch_parallel.py (N = 2^13, 8
Q + 4 P towers, 2 digits of 4): every shard of limb 4 at kql 8 (shard 1
holds own rows of both digits, shard 3 P rows only), shard 0 of limb 2,
and the level of 3 Q towers padded to 4 at limb 2, whose second digit
covers no row of y (n writes its rows as zeros) and whose pad row o writes
as zeros (zero weights). Then the wrappers' launches and refusals, and the
entries' registration against their C signatures.
"""

import collections
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openfhe_tpu.parallel import sharded_fused as jsf  # noqa: E402
from openfhe_tpu.pke.keyswitch import ks_fused as jks  # noqa: E402
from openfhe_tpu_torch import _build  # noqa: E402
from openfhe_tpu_torch.math import modops as mo  # noqa: E402
from openfhe_tpu_torch.parallel import sharded_fused as sf  # noqa: E402
from openfhe_tpu_torch.pke.keyswitch import ks_fused  # noqa: E402
from test_torch_ks_cluster import (model_keymul, model_pconv,  # noqa: E402
                                   pconv_run_refuses)
from test_torch_parallel import _jax_shard, _rand, jax_side  # noqa
from test_torch_scale_conv_cluster import _c_signature  # noqa: E402

# (level's Q towers, padded to, limb, shard)
CASES = [(8, None, 4, idx) for idx in range(4)] + [
    (8, None, 2, 0), (3, 4, 2, 0), (3, 4, 2, 1)]
IDS = ["limb4-shard0", "limb4-shard1-both-digits", "limb4-shard2",
       "limb4-shard3-p-rows", "limb2-shard0", "padded-shard0",
       "padded-shard1-p-rows"]


@pytest.fixture(scope="module")
def shards(jax_side):
    """For each case: the port's shard view, the inputs (seeded words) and
    JAX's n and p on that shard's slices of its tables (interpret mode,
    jitted: the shards of one table set share a trace)."""
    cc = jax_side["cc"]
    n = cc.ring_dim
    rng = np.random.default_rng(21)
    out, tables = {}, {}
    conv_rows = jax.jit(jsf._conv_digits_rows, static_argnums=2)
    keymul_rows = jax.jit(jsf._ntt_keymul_acc_sharded, static_argnums=3)
    p_to_q_rows = jax.jit(jsf._conv_p_to_q_rows, static_argnums=2)
    rng_o = np.random.default_rng(22)
    jks.INTERPRET = True
    try:
        for size, pad, limb, idx in CASES:
            if (size, pad) not in tables:
                tables[size, pad] = jsf.make_sharded_fused_tables(
                    cc, size, pad_to=pad)
            st = tables[size, pad]
            kql, nd, alpha = st.kql, st.nd, st.alpha
            v = sf.shard_view(jax_side["tabs"](size, pad), limb, idx, "cpu")
            assert (v.kql, v.nd, v.alpha, v.kql_real) == (kql, nd, alpha,
                                                          size)
            rows = v.basis_qlp.k
            mq = list(cc.moduli_q[:kql])
            y = np.concatenate([_rand(rng, mq[j * alpha:(j + 1) * alpha], n)
                                for j in range(nd)])             # [kql, N]
            c2 = _rand(rng, mq, n)
            conv = _rand(rng, v.basis_qlp.moduli, n, (nd,))  # [nd, rows, N]
            sl = jax.tree_util.tree_map(jnp.asarray,
                                        _jax_shard(st, idx, limb))
            y2 = np.concatenate([y, np.zeros((nd * alpha - kql, n),
                                             np.uint32)])
            take = np.minimum(v.tau0 + np.arange(rows), kql - 1)
            conv4 = conv.transpose(1, 0, 2).reshape(rows, nd, st.r, st.c)
            jn = np.asarray(conv_rows(jnp.asarray(y2), sl, rows * nd))
            jp = np.asarray(keymul_rows(
                jnp.asarray(conv4),
                jnp.asarray(c2[take].reshape(rows, st.r, st.c)), sl, rows))
            pc = _rand(rng_o, cc.moduli_p, n, (2,))         # [2, kp, N]
            jo = np.asarray(p_to_q_rows(jnp.asarray(pc), sl, v.q.kql))
            out[(size, pad, limb, idx)] = dict(
                v=v, y=y, c2=c2, conv=conv, pc=pc,
                n=jn.reshape(rows, nd, n).transpose(1, 0, 2),
                p=jp.reshape(2, rows, n), o=jo)
    finally:
        jks.INTERPRET = False
    return out


def model_n(y, v, splits):
    """conv_digits_rows' pconv: y [kql, N] read in place, digit j's rows
    with the shard's weight columns conv_w[j], output row j global row
    tau0 + j, own rows below kql_real zero."""
    b = v.basis_qlp
    out, _ = model_pconv(y, mo.to_u32(v.conv_w), mo.to_u32(v.conv_w_sh),
                         np.array(b.moduli, np.uint64), mo.to_u32(v.red),
                         v.alpha, v.kql, splits=splits, d_off=v.tau0,
                         own_end=v.kql_real)
    return out


def model_o(pc, v, splits):
    """conv_p_to_q_rows' pconv: pc [2, kp, N] read in place as batch 2 of
    kp rows over one table (the shard's weight columns pconv_w, w_stride
    0), the shard's Q moduli and their red64 rows, no own rows."""
    kp = v.pconv_w.shape[0]
    bq = v.q.basis_ql
    both = lambda t: np.broadcast_to(mo.to_u32(t), (2,) + tuple(t.shape))
    out, _ = model_pconv(pc.reshape(2 * kp, -1), both(v.pconv_w),
                         both(v.pconv_w_sh), np.array(bq.moduli, np.uint64),
                         mo.to_u32(bq.red64), kp, 2 * kp, splits=splits)
    return out


def model_p(conv, c2, v, log_w):
    """ntt_keymul_acc_rows' keymul_cluster: the shard's rows from global
    row tau0, own rows below kql_real, the shard's key rows unshifted."""
    b = v.basis_qlp
    u64 = lambda t: mo.to_u32(t).astype(np.uint64)
    return model_keymul(conv.astype(np.uint64), c2.astype(np.uint64),
                        tuple(u64(k) for k in v.keys), u64(b.psi_br),
                        np.array(b.moduli, np.uint64), b.k, v.alpha, 0,
                        log_w, tau0=v.tau0, own_end=v.kql_real)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_o_model_matches_jax_kernel_and_twin(shards, case):
    """o: model == JAX's kernel == the port's twin, word for word, with the
    shard's Q rows split over 1 and 3 blocks; the padded level's pad row
    (zero weights) is zero."""
    s = shards[case]
    v = s["v"]
    twin = mo.to_u32(sf.conv_p_to_q_rows(mo.u32_tensor(s["pc"]), v))
    for splits in (1, 3):
        got = model_o(s["pc"], v, splits)
        np.testing.assert_array_equal(got, s["o"])
        np.testing.assert_array_equal(got, twin)
    size, pad, limb, idx = case
    real = min(v.q.kql, max(0, size - v.q0))
    assert not got[:, real:].any() and got[:, :real].any(axis=-1).all()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_models_match_jax_kernels_and_twins(shards, case):
    """n and p: model == JAX's kernel == the port's twin, word for word;
    p at clusters of one block (log W = 13, N = 2^13's geometry) and of 8
    (log W = 10, the main path's), n with the rows split over 3 blocks."""
    s = shards[case]
    v = s["v"]
    np.testing.assert_array_equal(mo.to_u32(v.red),
                                  mo.to_u32(v.basis_qlp.red64))
    got_n = model_n(s["y"], v, splits=3)
    np.testing.assert_array_equal(got_n, s["n"])
    np.testing.assert_array_equal(
        got_n, mo.to_u32(sf.conv_digits_rows(mo.u32_tensor(s["y"]), v)))
    twin_p = mo.to_u32(sf.ntt_keymul_acc_rows(
        mo.u32_tensor(s["conv"]), mo.u32_tensor(s["c2"]), v))
    for log_w in (13, 10):
        got_p = model_p(s["conv"], s["c2"], v, log_w)
        np.testing.assert_array_equal(got_p, s["p"])
        np.testing.assert_array_equal(got_p, twin_p)
    size, pad, limb, idx = case
    if pad:
        # digit 1 has no row of y (kql 4 <= alpha): all zeros; digit 0's
        # rows are own (0-2) or the pad row (3, zero weights) on shard 0,
        # converted on shard 1's P rows
        assert not got_n[1].any()
        assert got_n[0].any(axis=-1).all() == (idx == 1)
        assert got_n[0].any() == (idx == 1)


def _launches(monkeypatch):
    """Record each launch; a launch of n's entry is refused where
    pconv_run would refuse it (modelled), as the card raises."""
    calls = []

    def launch(src, fn, *args):
        calls.append((src, fn, args))
        if fn == "conv_digits_rows":
            y, out = args[0], args[5]
            nd, alpha, kql, rows, tau0, own_end, n = args[6:]
            _build.record_launch(int(pconv_run_refuses(
                y.data_ptr(), out.data_ptr(), nd, alpha, kql, rows, n,
                alpha * rows, tau0, own_end)), fn)
        if fn == "conv_p_to_q_rows":
            x, out = args[0], args[5]
            e, kp, rows, n = args[6:]
            _build.record_launch(int(pconv_run_refuses(
                x.data_ptr(), out.data_ptr(), e, kp, e * kp, rows, n)), fn)
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())
    monkeypatch.setattr(ks_fused, "_check", lambda *a, **k: None)
    return calls


@pytest.mark.parametrize("case", [(8, None, 4, 1), (3, 4, 2, 0)],
                         ids=["limb4-shard1", "padded-shard0"])
def test_wrappers_launch_one_entry_or_raise(jax_side, monkeypatch, case):
    """Off the CPU, n launches `conv_digits_rows` once on y [kql, N] itself
    (no padded copy: the sharded chain calls no `_pad_digits`), with the
    shard's red rows and (nd, alpha, kql, rows, tau0, kql_real, N), an
    empty digit included; y off a 16-byte boundary raises. p launches
    `ntt_keymul_acc_rows` once without scratch, (nd, alpha, rows, tau0,
    kql_real, log2 N); o launches `conv_p_to_q_rows` once on pc itself
    with the shard's Q moduli and their red64 rows and (2, kp, kql_loc,
    N); pc off a 16-byte boundary raises. The former forms launch their
    own entries (p's with scratch, o's without red) and take no CPU
    tensor."""
    size, pad, limb, idx = case
    v = sf.shard_view(jax_side["tabs"](size, pad), limb, idx, "cpu")
    n, rows, nd = v.basis_qlp.ring_dim, v.basis_qlp.k, v.nd
    cpu = lambda *s: torch.zeros(s, dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        sf.conv_digits_rows_rowmod(cpu(nd, v.alpha, n), v)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        sf.ntt_keymul_acc_rows_staged(cpu(nd, rows, n), cpu(v.kql, n), v)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        sf.conv_p_to_q_rows_rowmod(cpu(2, v.pconv_w.shape[0], n), v)
    assert "_pad_digits" not in inspect.getsource(sf.mult_relin_fused_local)
    calls = _launches(monkeypatch)
    y = cpu(v.kql, n)
    out = sf._conv_digits_rows_cu(y, v)
    (src, fn, args), = calls
    assert (src, fn) == ("sharded", "conv_digits_rows")
    assert args[0] is y and args[4] is v.red and args[5] is out
    assert args[6:] == (nd, v.alpha, v.kql, rows, v.tau0, size, n)
    assert tuple(out.shape) == (nd, rows, n)
    calls.clear()
    y_off = cpu(v.kql * n + 1)[1:].view(v.kql, n)
    with pytest.raises(RuntimeError, match="conv_digits_rows: CUDA launch "
                       "failed with error 1"):
        sf._conv_digits_rows_cu(y_off, v)
    assert [c[1] for c in calls] == ["conv_digits_rows"]
    conv, c2 = cpu(nd, rows, n), cpu(v.kql, n)
    for wrap, entry, n_ptr in (
            (lambda *a: sf._ntt_keymul_acc_rows_cu(*a, "ntt_keymul_acc_rows"),
             "ntt_keymul_acc_rows", 10),
            (lambda *a: sf._ntt_keymul_acc_rows_cu(
                *a, "ntt_keymul_acc_rows_staged"),
             "ntt_keymul_acc_rows_staged", 11)):
        calls.clear()
        ext = wrap(conv, c2, v)
        (src, fn, args), = calls
        assert (src, fn) == ("sharded", entry)
        assert args[0] is conv and args[1] is c2 and args[n_ptr - 4] is ext
        assert args[n_ptr:] == (nd, v.alpha, rows, v.tau0, size,
                                n.bit_length() - 1)
        assert tuple(ext.shape) == (2, rows, n)
    calls.clear()
    y_pad = cpu(nd, v.alpha, n)
    sf.conv_digits_rows_rowmod(y_pad, v)
    (src, fn, args), = calls
    assert (fn, args[0], args[5:]) == ("conv_digits_rows_rowmod", y_pad,
                                       (nd, v.alpha, rows, n))
    # o: one launch of conv_p_to_q_rows on pc itself with the shard's Q
    # rows' red64; its former form takes no red and no CPU tensor
    kp, kql_loc = v.pconv_w.shape
    pc = cpu(2, kp, n)
    calls.clear()
    convq = sf._conv_p_to_q_rows_cu(pc, v, "conv_p_to_q_rows")
    (src, fn, args), = calls
    bq = v.q.basis_ql
    assert (src, fn) == ("sharded", "conv_p_to_q_rows")
    assert args[0] is pc and args[1] is v.pconv_w and args[5] is convq
    assert args[3] is bq.q and args[4] is bq.red64
    assert args[6:] == (2, kp, kql_loc, n)
    assert tuple(convq.shape) == (2, kql_loc, n)
    np.testing.assert_array_equal(
        mo.to_u32(bq.red64), [mo.mod_constants(q) for q in bq.moduli])
    calls.clear()
    pc_off = cpu(2 * kp * n + 1)[1:].view(2, kp, n)
    with pytest.raises(RuntimeError, match="conv_p_to_q_rows: CUDA launch "
                       "failed with error 1"):
        sf._conv_p_to_q_rows_cu(pc_off, v, "conv_p_to_q_rows")
    assert [c[1] for c in calls] == ["conv_p_to_q_rows"]
    calls.clear()
    sf._conv_p_to_q_rows_cu(pc, v, "conv_p_to_q_rows_rowmod")
    (src, fn, args), = calls
    assert (src, fn) == ("sharded", "conv_p_to_q_rows_rowmod")
    assert args[0] is pc and args[3] is bq.q
    assert args[5:] == (2, kp, kql_loc, n)


@pytest.mark.parametrize("source,fn", [
    ("sharded", "conv_digits_rows"), ("sharded", "conv_digits_rows_rowmod"),
    ("sharded", "ntt_keymul_acc_rows"),
    ("sharded", "ntt_keymul_acc_rows_staged"),
    ("sharded", "conv_p_to_q_rows"), ("sharded", "conv_p_to_q_rows_rowmod"),
    ("ks_fused", "ntt_keymul_acc"), ("ks_fused", "conv_digits")])
def test_entries_are_registered_with_their_c_signatures(source, fn):
    """SOURCES holds each entry of n, o and p (and K3's and K2's, which
    now share their kernels) with the argtypes of its C signature: n takes
    red and (tau0, own_end) beyond its former form, o red beyond its
    former form, p no scratch."""
    assert _build.SOURCES[source][fn] == _c_signature(source, fn)
    p, i = _build._P, _build._I
    want = {"conv_digits_rows": [p] * 6 + [i] * 7 + [p],
            "conv_digits_rows_rowmod": [p] * 5 + [i] * 4 + [p],
            "ntt_keymul_acc_rows": [p] * 10 + [i] * 6 + [p],
            "ntt_keymul_acc_rows_staged": [p] * 11 + [i] * 6 + [p],
            "conv_p_to_q_rows": [p] * 6 + [i] * 4 + [p],
            "conv_p_to_q_rows_rowmod": [p] * 5 + [i] * 4 + [p],
            "ntt_keymul_acc": [p] * 10 + [i] * 6 + [p],
            "conv_digits": [p] * 6 + [i] * 5 + [p]}
    assert _build.SOURCES[source][fn] == want[fn]
