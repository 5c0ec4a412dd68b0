"""K1t and K6 of the fused key switch on the cluster NTT, on the CPU.

`csrc/ks_fused.cu` runs `tensor_intt` (K1t) as one launch of
`tensor_intt_cluster` and `ntt_subscale` (K6) as one launch of
`subscale_cluster`. There is no card here, so both are modelled in numpy
with the cluster NTT's own models (tests/test_torch_ntt_cluster.py): K1t
as the inverse transform whose load hook forms c2 = a1 b1 on each
thread's 16 consecutive words (the 64-bit product reduced by
`reduce_wide` with `Basis.red64`), writes c2 at the words it read and
hands them on, with k1_scale (N^-1 (B_j/b_i)^-1) as the last multiply;
K6 as the forward transform of convq[e, tau] in cluster c (e = c % 2,
tau = c / 2) whose epilogue reads ext at the words `fwd_out_word` names,
multiplies by t (Shoup, only when t != 1), subtracts, multiplies by P^-1
and adds element e's addend where one is given.

Each model must be word-equal (tolerance 0) to JAX's Pallas kernels
`_tensor_intt` (tower pairs), `_tensor_intt_single` and `_ntt_subscale`
(interpret mode, as tests/test_ks_fused.py runs them) and to the port's
plain twins: on 3 Q + 2 P 27-bit primes at N = 2^12, kql odd (3) and even
(2), t = 1 and 65537, clusters of 1, 4 and 8 blocks; on the largest 31-bit
primes to the twins and to JAX's NTT with exact products. Then the key
switch's addends against the final add, the shape-only choice of the
staged forms, the wrappers' refusals and checks, and the entries'
argtypes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openfhe_tpu.lattice import basis as jbasis  # noqa: E402
from openfhe_tpu.ops import ntt as jntt  # noqa: E402
from openfhe_tpu.pke.keyswitch import ks_fused as jks  # noqa: E402
from openfhe_tpu_torch import _build  # noqa: E402
from openfhe_tpu_torch.lattice.basis import make_basis  # noqa: E402
from openfhe_tpu_torch.math import modops as mo  # noqa: E402
from openfhe_tpu_torch.math import nbtheory  # noqa: E402
from openfhe_tpu_torch.pke.keys import EvalKey  # noqa: E402
from openfhe_tpu_torch.pke.keyswitch import hybrid, ks_fused  # noqa: E402
from test_torch_ks_cluster import (MASK, R, _rand, _top31,  # noqa: E402
                                   csub, fwd_out_word, reduce_wide, shoup)
from test_torch_ntt_cluster import (_kara_moduli, model_fwd,  # noqa: E402
                                    model_inv)

N = 1 << 12
T_BGV = 65537


# ---------------------------------------------------------------------------
# the kernels' schedules, in numpy (uint64 words)
# ---------------------------------------------------------------------------

def model_tensor_intt(a1, b1, tabs, log_w):
    """tensor_intt_cluster: a1, b1 [kql, N] -> (c2, y) [kql, N], a cluster
    per Q tower."""
    kql, n = a1.shape
    bq = tabs.basis_ql
    q = np.array(bq.moduli, np.uint64)
    red = mo.to_u32(bq.red64).astype(np.uint64)
    ipsi = mo.to_u32(bq.ipsi_br).astype(np.int64)
    scale = mo.to_u32(tabs.k1_scale).astype(np.int64)[:, 0]
    c2 = np.zeros((kql, n), np.uint64)
    written = np.zeros((kql, n), int)
    y = np.empty((kql, n), np.int64)
    for tau in range(kql):
        def load(rank, idx, tau=tau):
            # 16 consecutive words a thread from a multiple of 16
            assert (idx == idx[:, :1] + np.arange(R)).all()
            assert (idx[:, 0] % R == 0).all()
            prod = a1[tau][idx].astype(np.uint64) * b1[tau][idx]
            words = reduce_wide(prod, q[tau], red[tau])
            c2[tau, idx] = words             # at the words it read
            written[tau, idx] += 1
            return words[None].astype(np.int64)

        y[tau] = model_inv(np.zeros((1, n), np.int64), ipsi[tau][None],
                           q[tau:tau + 1].astype(np.int64),
                           scale[tau:tau + 1], log_w, load)[0]
    assert (written == 1).all()
    return c2, y.astype(np.uint64)


def model_subscale(convq, ext, tabs, log_w, adds=(None, None)):
    """subscale_cluster: convq [2, kql, N], ext [2, kqlp, N] (rows tau <
    kql read), adds (add0, add1), each None or [kql, N] -> [2, kql, N]."""
    kql, n = convq.shape[1], convq.shape[2]
    log_n = n.bit_length() - 1
    bq = tabs.basis_ql
    q = np.array(bq.moduli, np.uint64)
    psi = mo.to_u32(bq.psi_br).astype(np.int64)
    col = lambda t: mo.to_u32(t).astype(np.uint64)[:, 0]
    pv, pv_sh = col(tabs.pinv_q), col(tabs.pinv_q_sh)
    tv, tv_sh = col(tabs.t_modq), col(tabs.t_modq_sh)
    out = np.zeros((2, kql, n), np.uint64)
    written = np.zeros((2, kql, n), int)
    for cluster in range(2 * kql):              # an element row a cluster
        e, tau = cluster % 2, cluster // 2
        qt = q[tau]

        def epi(rank, a, idx, e=e, tau=tau, qt=qt):
            assert (idx[:, 0] == fwd_out_word(rank, log_n, log_w)).all()
            word = a[0].astype(np.uint64)
            if not tabs.t_is_one:
                word = shoup(word, tv[tau], tv_sh[tau], qt)
            xe = ext[e, tau][idx].astype(np.uint64)
            d = shoup(csub((xe - word + qt) & MASK, qt), pv[tau], pv_sh[tau],
                      qt)
            if adds[e] is not None:
                d = csub(d + adds[e][tau][idx].astype(np.uint64), qt)
            out[e, tau, idx] = d
            written[e, tau, idx] += 1

        model_fwd(convq[e, tau][None].astype(np.int64), psi[tau][None],
                  q[tau:tau + 1].astype(np.int64), log_w, epi)
    assert (written == 1).all()
    return out


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def _case(mq, mp, kql, seed, ns_int=1):
    """Port tables and inputs for the level with kql of the Q towers mq (2
    digits over the full chain)."""
    rng = np.random.default_rng(seed)
    qlp = mq[:kql] + mp
    tabs = ks_fused.make_fused_ks_tables(make_basis(qlp, N), kql, len(mq), 2,
                                         ns_int=ns_int)
    return dict(tabs=tabs, a1=_rand(rng, mq[:kql]), b1=_rand(rng, mq[:kql]),
                convq=_rand(rng, mq[:kql], (2,)), ext=_rand(rng, qlp, (2,)),
                adds=[_rand(rng, mq[:kql]) for _ in range(2)])


def _twins(case, adds=(None, None)):
    t, u = case["tabs"], mo.u32_tensor
    c2, y = ks_fused.tensor_intt(u(case["a1"]), u(case["b1"]), t)
    k6 = ks_fused.ntt_subscale(u(case["convq"]), u(case["ext"]), t,
                               *(None if a is None else u(a) for a in adds))
    return mo.to_u32(c2), mo.to_u32(y), mo.to_u32(k6)


def _add(x, add, moduli):
    """x + add mod q, row by row (numpy, exact)."""
    q = np.array(moduli, np.uint64).reshape(-1, 1)
    return (x.astype(np.uint64) + add.astype(np.uint64)) % q


@pytest.fixture(scope="module")
def chain27():
    """3 Q + 2 P 27-bit primes (JAX's Karatsuba kernels take them) at level
    0 (kql 3, odd: JAX pairs the towers and pads the last pair with a
    garbage tower) and level 1 (kql 2), t = 1 and 65537, with JAX's K1t
    (both forms) and K6 in interpret mode."""
    mods = _kara_moduli(N, 5)
    mq, mp = mods[:3], mods[3:]
    out = {}
    jks.INTERPRET = True
    try:
        for kql in (3, 2):
            for ns_int in (1, T_BGV):
                case = _case(mq, mp, kql, kql, ns_int)
                jt = jks.make_fused_ks_tables(mq, mp, kql, 2, N, len(mq),
                                              ns_int=ns_int, pad_to=None)
                r, c = jt.r, jt.c
                u = lambda x: jnp.asarray(x.astype(np.uint32))
                case["jax_k6"] = np.asarray(jks._ntt_subscale(
                    u(case["convq"]).reshape(2, kql, r, c),
                    u(case["ext"]).reshape(2, kql + len(mp), r, c),
                    jt)).reshape(2, kql, N)
                if ns_int == 1:       # K1t reads no t
                    a1, b1 = (u(case[k]).reshape(kql, r, c)
                              for k in ("a1", "b1"))
                    case["jax_k1t"] = [
                        tuple(np.asarray(v).reshape(kql, N)
                              for v in fn(a1, b1, jt))
                        for fn in (jks._tensor_intt, jks._tensor_intt_single)]
                out[kql, ns_int] = case
    finally:
        jks.INTERPRET = False
    return out


@pytest.mark.parametrize("kql,ns_int,log_w",
                         [(3, 1, 12), (3, T_BGV, 10), (2, 1, 9),
                          (2, T_BGV, 12)],
                         ids=["odd-t1-C1", "odd-t65537-C4", "even-t1-C8",
                              "even-t65537-C1"])
def test_models_match_jax_kernels_and_twins(chain27, kql, ns_int, log_w):
    case = chain27[kql, ns_int]
    t = case["tabs"]
    assert t.t_is_one == (ns_int == 1)
    k6 = model_subscale(case["convq"], case["ext"], t, log_w)
    np.testing.assert_array_equal(k6, case["jax_k6"])
    c2, y = model_tensor_intt(case["a1"], case["b1"], t, log_w)
    twin_c2, twin_y, twin_k6 = _twins(case)
    np.testing.assert_array_equal(k6, twin_k6)
    np.testing.assert_array_equal(c2, twin_c2)
    np.testing.assert_array_equal(y, twin_y)
    # K1t reads no t: both t cases share the seed, so a1 and b1
    for want_c2, want_y in chain27[kql, 1]["jax_k1t"]:
        np.testing.assert_array_equal(c2, want_c2)
        np.testing.assert_array_equal(y, want_y)


@pytest.mark.parametrize("adds", [(0,), (0, 1), (1,)],
                         ids=["add0", "add0-add1", "add1"])
def test_subscale_addends_match_jax_and_twin(chain27, adds):
    """K6 with one or two addends: the model and the twin equal JAX's
    `_ntt_subscale` followed by the caller's final add."""
    case = chain27[3, T_BGV]
    mq = case["tabs"].basis_ql.moduli
    given = [case["adds"][e] if e in adds else None for e in range(2)]
    got = model_subscale(case["convq"], case["ext"], case["tabs"], 10, given)
    want = np.stack([x if a is None else _add(x, a, mq)
                     for x, a in zip(case["jax_k6"], given)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _twins(case, given)[2])


@pytest.mark.parametrize("log_w,kql,ns_int", [(12, 3, 1), (10, 4, T_BGV)],
                         ids=["C1-odd-t1", "C4-even-t65537"])
def test_models_on_31_bit_primes_match_jax_ntt_and_twins(log_w, kql,
                                                          ns_int):
    """4 Q + 2 P of the largest 31-bit primes: the models against the twins
    and against JAX's stage transforms with exact products (a1 b1 mod q,
    N^-1 and (B_j/b_i)^-1 as Python integers; t, P^-1 and the addends
    likewise)."""
    mods = _top31(6)
    mq, mp = mods[:4], mods[4:]
    case = _case(mq, mp, kql, 31 + kql, ns_int)
    t = case["tabs"]
    adds = (case["adds"][0], case["adds"][1] if ns_int != 1 else None)
    c2, y = model_tensor_intt(case["a1"], case["b1"], t, log_w)
    k6 = model_subscale(case["convq"], case["ext"], t, log_w, adds)
    twin_c2, twin_y, twin_k6 = _twins(case, adds)
    np.testing.assert_array_equal(c2, twin_c2)
    np.testing.assert_array_equal(y, twin_y)
    np.testing.assert_array_equal(k6, twin_k6)
    ql = mq[:kql]
    q = np.array(ql, np.uint64).reshape(-1, 1)
    jb = jbasis.make_basis(ql, N)
    want_c2 = case["a1"] * case["b1"] % q
    np.testing.assert_array_equal(c2, want_c2)
    inv = np.asarray(jntt.ntt_inv(jnp.asarray(want_c2.astype(np.uint32)),
                                  jb)).astype(np.uint64)
    alpha = t.alpha
    bhat = [int(np.prod([int(v) for v in ql[j * alpha:(j + 1) * alpha]],
                        dtype=object)) for j in range(t.nd)]
    bhatinv = np.array([pow(bhat[i // alpha] // qi % qi, -1, qi)
                        for i, qi in enumerate(ql)], np.uint64)[:, None]
    np.testing.assert_array_equal(y, inv * bhatinv % q)
    big_p = int(np.prod([int(p) for p in mp], dtype=object))
    pinv = np.array([pow(big_p % qi, -1, qi) for qi in ql],
                    np.uint64)[:, None]
    s = np.asarray(jntt.ntt_fwd(jnp.asarray(case["convq"].astype(np.uint32)),
                                jb)).astype(np.uint64) * (ns_int % q) % q
    want = (case["ext"][:, :kql] + q - s) % q * pinv % q
    want = np.stack([x if a is None else _add(x, a, ql)
                     for x, a in zip(want, adds)])
    np.testing.assert_array_equal(k6, want)


def test_keyswitch_core_addends_equal_the_final_add():
    """`hybrid.keyswitch_core` with addends, fused tables attached on the
    CPU (the twins, the addends in K6) and unfused (the add after the
    mod-down), equals the key switch without them plus add_mod."""
    mods = _top31(6)
    mq, mp = mods[:4], mods[4:]
    rng = np.random.default_rng(4)
    u = mo.u32_tensor
    halves = [u(_rand(rng, mods, (2,))) for _ in range(2)]
    ek = hybrid.shoup_companions(EvalKey(bv=halves[0], av=halves[1]), mods)
    tabs = hybrid.make_hybrid_tables(make_basis(mq, N), make_basis(mp, N), 3,
                                     2)
    fused = dataclasses.replace(tabs, fused=ks_fused.make_fused_ks_tables(
        make_basis(mq[:3] + mp, N), 3, 4, 2))
    c = u(_rand(rng, mq[:3]))
    adds = [u(_rand(rng, mq[:3])) for _ in range(2)]
    q = tabs.basis_ql.q
    for t in (tabs, fused):
        d0, d1 = hybrid.keyswitch_core(c, ek, t)
        for add0, add1 in ((adds[0], adds[1]), (adds[0], None)):
            got = hybrid.keyswitch_core(c, ek, t, add0, add1)
            want = (mo.add_mod(add0, d0, q),
                    d1 if add1 is None else mo.add_mod(add1, d1, q))
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(
        hybrid.keyswitch_core(c, ek, fused, *adds),
        hybrid.keyswitch_core(c, ek, tabs, *adds)))


# ---------------------------------------------------------------------------
# the entries and their choice
# ---------------------------------------------------------------------------

def test_staged_forms_serve_other_rings_by_shape(monkeypatch):
    """tensor_intt and ntt_subscale launch the cluster entry for 2^4 <= N
    <= 2^17 and the staged one for every other ring; the choice reads the
    ring alone, and both K6 forms take the addends."""
    calls = []
    monkeypatch.setattr(ks_fused, "_tensor_intt_cu",
                        lambda a1, b1, t, entry: calls.append(
                            (t.basis_qlp.ring_dim, entry)))
    monkeypatch.setattr(ks_fused, "_ntt_subscale_cu",
                        lambda cq, ext, t, a0, a1, entry: calls.append(
                            (t.basis_qlp.ring_dim, a0 is not None,
                             a1 is not None, entry)))
    want = []
    for log_n in (3, 4, 12, 16, 17, 18):
        n = 1 << log_n
        mods = [nbtheory.first_prime(bits, 2 * n) for bits in (30, 31)]
        tabs = ks_fused.make_fused_ks_tables(make_basis(mods, n), 1, 1, 1)
        x = torch.empty((2, 1, n), dtype=torch.int32, device="meta")
        ks_fused.tensor_intt(x[0], x[0], tabs)
        ks_fused.tensor_intt_staged(x[0], x[0], tabs)
        ks_fused.ntt_subscale(x, x, tabs, x[0])
        ks_fused.ntt_subscale_staged(x, x, tabs, None, x[1])
        form = "" if 4 <= log_n <= 17 else "_staged"
        want += [(n, "tensor_intt" + form), (n, "tensor_intt_staged"),
                 (n, True, False, "ntt_subscale" + form),
                 (n, False, True, "ntt_subscale_staged")]
    assert calls == want


def test_wrappers_refuse_the_cpu_and_check_addends():
    """The staged forms take CUDA tensors only; the twin takes an addend of
    [kql, N] only (on the card `_check` holds it to that too), and on a
    device without a kernel the wrappers raise without reaching a twin."""
    mods = _top31(3)
    tabs = ks_fused.make_fused_ks_tables(make_basis(mods, N), 2, 2, 2)
    zeros = lambda *s: torch.zeros(s + (N,), dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ks_fused.tensor_intt_staged(zeros(2), zeros(2), tabs)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ks_fused.ntt_subscale_staged(zeros(2, 2), zeros(2, 3), tabs)
    for bad in (zeros(3), zeros(1, 2), zeros(2)[:, :N // 2]):
        with pytest.raises(ValueError, match="add1 has shape"):
            ks_fused.ntt_subscale(zeros(2, 2), zeros(2, 3), tabs, zeros(2),
                                  bad)
    meta = lambda *s: torch.empty(s + (N,), dtype=torch.int32,
                                  device="meta")
    for call in (lambda: ks_fused.tensor_intt(meta(2), meta(2), tabs),
                 lambda: ks_fused.ntt_subscale(meta(2, 2), meta(2, 3), tabs,
                                               meta(2), meta(2))):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()
    # on the CPU the twin adds the addend it is given
    rng = np.random.default_rng(2)
    convq, ext = _rand(rng, mods[:2], (2,)), _rand(rng, mods, (2,))
    add = _rand(rng, mods[:2])
    u = mo.u32_tensor
    base = mo.to_u32(ks_fused.ntt_subscale(u(convq), u(ext), tabs))
    got = mo.to_u32(ks_fused.ntt_subscale(u(convq), u(ext), tabs, None,
                                          u(add)))
    np.testing.assert_array_equal(got[0], base[0])
    np.testing.assert_array_equal(got[1], _add(base[1], add, mods[:2]))


def test_entries_are_registered():
    """Both forms of K1t and K6 are entry points of ks_fused.cu's library,
    with the argtypes their wrappers pass: the cluster K1t also reads the
    Q_l towers' Basis.red64, the staged K6 takes scratch, and both K6
    forms take the two addends' pointers."""
    src = _build.SOURCES["ks_fused"]
    p, i = _build._P, _build._I
    assert src["tensor_intt"] == [p] * 10 + [i] * 2 + [p]
    assert src["tensor_intt_staged"] == [p] * 9 + [i] * 2 + [p]
    assert src["ntt_subscale"] == [p] * 12 + [i] * 4 + [p]
    assert src["ntt_subscale_staged"] == [p] * 13 + [i] * 4 + [p]
