"""K6f and K2 of the fused key switch, on the CPU.

`csrc/ks_fused.cu` runs `ntt_submul_final` (K6f) as one launch of
`submul_cluster` and `conv_digits` (K2) as one launch of `pconv`. There is
no card here, so both are modelled in numpy: K6f with the cluster NTT's
own model (tests/test_torch_ntt_cluster.py) run on convq[e, tau] of each
cluster c (e = c % 2, tau = c / 2), the epilogue reading ext (at row
ext_off + tau) and a0, a1, b0, b1 at the words `fwd_out_word` names and
forming c0 = a0 b0, c1 = a0 b1 + a1 b0 by `reduce_wide` and the mod-down
by a Shoup multiply; K2 with `pconv`'s model (tests/test_torch_ks_cluster.py)
on y's digits read in place, each digit's own weights, its own rows
written as zeros and the rows split over blocks.

Each model must be word-equal (tolerance 0) to JAX's Pallas kernels
`_ntt_submul_final` / `_conv_digits` (interpret mode, as
tests/test_ks_fused.py runs them) and to the port's plain twins: on 3 Q +
2 P 27-bit primes at N = 2^12 (two digits, the last of one tower, and the
one-digit level below), at level 1 of a 31 + 16 tower chain (digits of 16
and 14 rows), K6f at clusters of 1, 4 and 8 blocks and with ext_off != 0;
on the largest 31-bit primes to the twins and to JAX's NTT with exact
products. Then `reduce_wide` at the edges of its range, the shape-only
choice of `ntt_submul_final_staged` and the wrappers' checks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openfhe_tpu.lattice import basis as jbasis  # noqa: E402
from openfhe_tpu.ops import ntt as jntt  # noqa: E402
from openfhe_tpu.pke.keyswitch import ks_fused as jks  # noqa: E402
from openfhe_tpu_torch.lattice.basis import make_basis  # noqa: E402
from openfhe_tpu_torch.math import modops as mo  # noqa: E402
from openfhe_tpu_torch.math import nbtheory  # noqa: E402
from openfhe_tpu_torch.pke.keyswitch import ks_fused  # noqa: E402
from test_torch_ks_cluster import (MASK, U32, _rand, _top31,  # noqa: E402
                                   csub, fwd_out_word, model_pconv,
                                   reduce_wide, shoup)
from test_torch_ntt_cluster import _kara_moduli, model_fwd  # noqa: E402

N = 1 << 12


# ---------------------------------------------------------------------------
# the kernels' schedules, in numpy (uint64 words)
# ---------------------------------------------------------------------------

def model_submul(convq, ext, inputs, tabs, ext_off, log_w):
    """submul_cluster: convq [2, kql, N], ext [2, R, N] (rows ext_off ..
    ext_off + kql - 1 read), inputs (a0, a1, b0, b1) each [kql, N] ->
    out [2, kql, N]."""
    kql, n = convq.shape[1], convq.shape[2]
    log_n = n.bit_length() - 1
    bq = tabs.basis_ql
    q = np.array(bq.moduli, np.uint64)
    psi = mo.to_u32(bq.psi_br).astype(np.int64)
    pv = mo.to_u32(tabs.pinv_q).astype(np.uint64)[:, 0]
    pv_sh = mo.to_u32(tabs.pinv_q_sh).astype(np.uint64)[:, 0]
    red = mo.to_u32(bq.red64).astype(np.uint64)
    a0, a1, b0, b1 = (x.astype(np.uint64) for x in inputs)
    out = np.zeros((2, kql, n), np.uint64)
    written = np.zeros((2, kql, n), int)
    for cluster in range(2 * kql):              # an element row a cluster
        e, tau = cluster % 2, cluster // 2
        qt = q[tau]

        def epi(rank, a, idx, e=e, tau=tau, qt=qt):
            assert (idx[:, 0] == fwd_out_word(rank, log_n, log_w)).all()
            word = a[0].astype(np.uint64)
            xe = ext[e, ext_off + tau][idx].astype(np.uint64)
            p0, q0 = a0[tau][idx], b0[tau][idx]
            if e == 0:
                t = p0 * q0
            else:
                t = p0 * b1[tau][idx] + a1[tau][idx] * q0
                assert t.max() < 1 << 63
            c = reduce_wide(t, qt, red[tau])
            diff = csub((xe - word + qt) & MASK, qt)     # sub_q
            d = shoup(diff, pv[tau], pv_sh[tau], qt)
            out[e, tau, idx] = csub(c + d, qt)
            written[e, tau, idx] += 1

        model_fwd(convq[e, tau][None].astype(np.int64), psi[tau][None],
                  q[tau:tau + 1].astype(np.int64), log_w, epi)
    assert (written == 1).all()
    return out


def model_conv_digits(y, tabs, splits):
    """conv_digits' pconv: y [kql, N] read in place, digit j's rows j alpha
    .. min((j + 1) alpha, kql) - 1 with weights conv_w[j], own rows zero."""
    b = tabs.basis_qlp
    out, _ = model_pconv(y, mo.to_u32(tabs.conv_w), mo.to_u32(tabs.conv_w_sh),
                         np.array(b.moduli, np.uint64), mo.to_u32(b.red64),
                         tabs.alpha, tabs.kql, own=True, splits=splits)
    return out


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def _case(mq, mp, kql, num_parts, seed, k_q_full=None, extra=0):
    """Port tables and inputs for the level with kql of the Q towers mq;
    ext has `extra` rows before the Q_l*P rows (ext_off = extra)."""
    rng = np.random.default_rng(seed)
    kf = k_q_full or len(mq)
    qlp = mq[:kql] + mp
    tabs = ks_fused.make_fused_ks_tables(make_basis(qlp, N), kql, kf,
                                         num_parts)
    ext = _rand(rng, qlp, (2,))
    if extra:
        ext = np.concatenate([_rand(rng, mq[:extra], (2,)), ext], axis=1)
    return dict(tabs=tabs, mq=mq[:kql], y=_rand(rng, mq[:kql]),
                convq=_rand(rng, mq[:kql], (2,)), ext=ext, ext_off=extra,
                inputs=[_rand(rng, mq[:kql]) for _ in range(4)])


def _jax_tables(case, mq, mp, num_parts, k_q_full):
    jt = jks.make_fused_ks_tables(mq, mp, len(case["mq"]), num_parts, N,
                                  k_q_full, pad_to=None)
    assert (jt.nd, jt.alpha) == (case["tabs"].nd, case["tabs"].alpha)
    return jt


def _jax_kernels(case, jt, k6f=True):
    """JAX's _ntt_submul_final (unless not k6f) and _conv_digits
    (interpret mode) on the case's inputs; ext from its Q_l*P rows on."""
    kql, r, c = jt.kql, jt.r, jt.c
    u = lambda x: jnp.asarray(x.astype(np.uint32))
    ext = case["ext"][:, case["ext_off"]:]
    out = None if not k6f else np.asarray(jks._ntt_submul_final(
        u(case["convq"]).reshape(2, kql, r, c),
        u(ext).reshape(2, ext.shape[1], r, c),
        *(u(x).reshape(kql, r, c) for x in case["inputs"]),
        jt)).reshape(2, kql, N)
    conv = jks._conv_digits(jks._pad_digits(u(case["y"]).reshape(kql, r, c),
                                            jt), jt)
    return out, np.asarray(conv)


def _twins(case):
    t, u = case["tabs"], mo.u32_tensor
    k6f = ks_fused.ntt_submul_final(u(case["convq"]), u(case["ext"]),
                                    *(u(x) for x in case["inputs"]), t,
                                    ext_off=case["ext_off"])
    return mo.to_u32(k6f), mo.to_u32(ks_fused.conv_digits(u(case["y"]), t))


@pytest.fixture(scope="module")
def chains27():
    """27-bit primes (JAX's Karatsuba kernels take them), with JAX's K6f
    and K2 in interpret mode: 3 Q + 2 P in 2 digits of alpha = 2 at level
    0 (kql 3: digit 1 has one tower, ext_off 1) and level 1 (kql 2: one
    digit); level 1 of 31 Q + 16 P (kql 30: digits of 16 and 14; K2 only,
    K6f's schedule does not depend on the digits)."""
    small = _kara_moduli(N, 5)
    big = _kara_moduli(N, 47)
    out = {}
    jks.INTERPRET = True
    try:
        for key, (mq, mp, kql, extra) in {
                "two-digits": (small[:3], small[3:], 3, 1),
                "one-digit": (small[:3], small[3:], 2, 0),
                "digits-16+14": (big[:31], big[31:], 30, 0)}.items():
            case = _case(mq, mp, kql, 2, kql, extra=extra)
            jt = _jax_tables(case, mq, mp, 2, len(mq))
            case["jax"] = _jax_kernels(case, jt, key != "digits-16+14")
            out[key] = case
    finally:
        jks.INTERPRET = False
    return out


@pytest.mark.parametrize("key,log_w", [("two-digits", 12),
                                       ("two-digits", 10),
                                       ("one-digit", 9),
                                       ("digits-16+14", None)],
                         ids=["two-digits-C1", "two-digits-C4",
                              "one-digit-C8", "digits-16+14"])
def test_models_match_jax_kernels_and_twins(chains27, key, log_w):
    case = chains27[key]
    t = case["tabs"]
    assert t.nd == (1 if key == "one-digit" else 2)
    k2 = model_conv_digits(case["y"], t, splits=3)
    want_k6f, want_k2 = case["jax"]
    twin_k6f, twin_k2 = _twins(case)
    np.testing.assert_array_equal(k2, want_k2)
    np.testing.assert_array_equal(k2, twin_k2)
    if want_k6f is not None:
        k6f = model_submul(case["convq"], case["ext"], case["inputs"], t,
                           case["ext_off"], log_w)
        np.testing.assert_array_equal(k6f, want_k6f)
        np.testing.assert_array_equal(k6f, twin_k6f)
    # each digit's own rows are zero, the others not
    for j in range(t.nd):
        own = range(j * t.alpha, min((j + 1) * t.alpha, t.kql))
        assert not k2[j, own].any()
        other = [tau for tau in range(k2.shape[1]) if tau not in own]
        assert k2[j, other].any(axis=-1).all()


@pytest.mark.parametrize("log_w,extra", [(12, 0), (10, 2)],
                         ids=["C1", "C4-ext_off-2"])
def test_models_on_31_bit_primes_match_jax_ntt_and_twins(log_w, extra):
    """4 Q + 2 P of the largest 31-bit primes in 2 digits: the models
    against the twins, and K6f against JAX's stage transform with exact
    products, K2 against the exact conversion."""
    mods = _top31(6)
    case = _case(mods[:4], mods[4:], 4, 2, 31 + extra, extra=extra)
    t = case["tabs"]
    k6f = model_submul(case["convq"], case["ext"], case["inputs"], t, extra,
                       log_w)
    k2 = model_conv_digits(case["y"], t, splits=2)
    twin_k6f, twin_k2 = _twins(case)
    np.testing.assert_array_equal(k6f, twin_k6f)
    np.testing.assert_array_equal(k2, twin_k2)
    q = np.array(mods[:4], np.uint64).reshape(-1, 1)
    jb = jbasis.make_basis(mods[:4], N)
    s = np.asarray(jntt.ntt_fwd(jnp.asarray(case["convq"].astype(np.uint32)),
                                jb)).astype(np.uint64)
    a0, a1, b0, b1 = (x.astype(np.uint64) for x in case["inputs"])
    c0 = a0 * b0 % q
    c1 = ((a0 + a1) % q * ((b0 + b1) % q) % q + 2 * q - c0
          - a1 * b1 % q) % q
    pinv = np.array([pow(int(np.prod([int(p) for p in mods[4:]],
                                      dtype=object)) % int(qi), -1, int(qi))
                     for qi in q[:, 0]], np.uint64).reshape(-1, 1)
    xq = case["ext"][:, extra:extra + 4].astype(np.uint64)
    want = np.stack([(c + (x - v + q) % q * pinv) % q
                     for c, x, v in zip((c0, c1), xq, s)])
    np.testing.assert_array_equal(k6f, want)
    qlp = np.array(mods, np.uint64)
    w = mo.to_u32(t.conv_w).astype(np.uint64)
    y = case["y"].astype(np.uint64)
    for j in range(t.nd):
        rows = y[j * t.alpha:(j + 1) * t.alpha]
        conv = sum(rows[i, None, :] * w[j, i, :, None] % qlp[:, None]
                   for i in range(rows.shape[0])) % qlp[:, None]
        np.testing.assert_array_equal(k2[j], conv)


# ---------------------------------------------------------------------------
# reduce_wide, the products of two variables
# ---------------------------------------------------------------------------

def _edge_words(q, rng, count=2000):
    edges = np.array([0, 1, q - 1, q - 2], np.uint64)
    return np.concatenate([edges, rng.integers(0, q, count, np.uint64)])


@pytest.mark.parametrize("q", [_top31(2, 1 << 17)[0], _top31(2, 1 << 17)[1],
                               nbtheory.first_prime(26, 1 << 17),
                               nbtheory.first_prime(27, 1 << 17), 97],
                         ids=["top31", "top31-2", "26-bit", "27-bit", "q97"])
def test_reduce_wide_is_exact(q):
    """Instruction by instruction (`reduce_wide` with `Basis.red64`'s
    row): a b mod q, and K6f's c1 sum a0 b1 + a1 b0 mod q, for a, b in {0,
    1, q - 1, q - 2} and random words; every word canonical."""
    red = mo.to_u32(make_basis([q], 16).red64)[0]
    assert tuple(int(v) for v in red) == mo.mod_constants(q)
    rng = np.random.default_rng(q % 1000)
    a = _edge_words(q, rng)
    qq = np.uint64(q)
    x = a[:, None] * a[None, :]                            # every pair
    got = reduce_wide(x, qq, red)
    want = np.array([[int(u) * int(v) % q for v in a] for u in a[:8]],
                    np.uint64)
    np.testing.assert_array_equal(got[:8], want)
    np.testing.assert_array_equal(got, x % qq)
    # the cross sum of two products, up to 2 (q - 1)^2 < 2^63
    s = x + x[::-1]
    assert s.max() >= (qq - 1) * (qq - 1)
    np.testing.assert_array_equal(reduce_wide(s, qq, red), s % qq)
    # any 64-bit word: the top of the range
    top = np.array([MASK << U32 | MASK, (MASK << U32) - 1, MASK],
                   np.uint64)
    np.testing.assert_array_equal(
        reduce_wide(top, qq, red),
        np.array([int(v) % q for v in top], np.uint64))


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------

def test_submul_staged_form_serves_other_rings_by_shape(monkeypatch):
    """ntt_submul_final launches the cluster entry for 2^4 <= N <= 2^17
    and the staged one for every other ring; the choice reads the ring
    alone, and both forms take ext_off."""
    calls = []
    monkeypatch.setattr(
        ks_fused, "_ntt_submul_final_cu",
        lambda *a: calls.append((a[6].basis_qlp.ring_dim,) + a[7:]))
    want = []
    for log_n in (3, 4, 16, 17, 18):
        n = 1 << log_n
        mods = [nbtheory.first_prime(bits, 2 * n) for bits in (30, 31)]
        tabs = ks_fused.make_fused_ks_tables(make_basis(mods, n), 1, 1, 1)
        x = torch.empty((2, 2, n), dtype=torch.int32, device="meta")
        ks_fused.ntt_submul_final(x, x, x, x, x, x, tabs, ext_off=1)
        ks_fused.ntt_submul_final_staged(x, x, x, x, x, x, tabs)
        form = "" if 4 <= log_n <= 17 else "_staged"
        want += [(n, 1, "ntt_submul_final" + form),
                 (n, 0, "ntt_submul_final_staged")]
    assert calls == want


def test_wrappers_check_ext_rows_and_refuse_the_cpu():
    """ext must hold rows ext_off .. ext_off + kql - 1; the former forms
    take CUDA tensors only, and the twins read ext at ext_off."""
    mods = _top31(3)
    tabs = ks_fused.make_fused_ks_tables(make_basis(mods, N), 2, 2, 2)
    meta = lambda *s: torch.empty(s + (N,), dtype=torch.int32,
                                  device="meta")
    for entry in (ks_fused.ntt_submul_final,
                  ks_fused.ntt_submul_final_staged):
        with pytest.raises(ValueError, match="has no rows 2 .. 3"):
            entry(meta(2, 2), meta(2, 3), *[meta(2)] * 4, tabs, ext_off=2)
    zeros = lambda *s: torch.zeros(s + (N,), dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ks_fused.ntt_submul_final_staged(zeros(2, 2), zeros(2, 3),
                                         *[zeros(2)] * 4, tabs)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ks_fused.conv_digits_rowmod(zeros(tabs.nd, tabs.alpha), tabs)
    # the twin reads the same words through ext_off as from a sliced ext
    case = _case(mods[:2], mods[2:], 2, 2, 5, extra=1)
    u = mo.u32_tensor
    args = (u(case["convq"]), *(u(x) for x in case["inputs"]))
    got = ks_fused.ntt_submul_final(args[0], u(case["ext"]), *args[1:],
                                    tabs, ext_off=1)
    want = ks_fused.ntt_submul_final(args[0], u(case["ext"][:, 1:]),
                                     *args[1:], tabs)
    assert torch.equal(got, want)
