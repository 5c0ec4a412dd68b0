"""K3 and K45 of the fused key switch on the cluster NTT, on the CPU.

`csrc/ks_fused.cu` runs `ntt_keymul_acc` (K3) as one launch of
`keymul_cluster` and `intt_conv_p` (K45) as the inverse cluster transform
and `pconv`. There is no card here, so their schedules are modelled in
numpy: the cluster NTT's own model is imported from
tests/test_torch_ntt_cluster.py and extended, for K3, with the cluster's
tower (the P towers first), its digit loop (the digit's own tower last,
read from c2 at the words `fwd_out_word` names), the key row `krow`, and
the key product as the epilogue of the transform's last round; for K45,
with the inverse transform's in-place read of ext's P rows and
k45_scale as its last multiply, then `pconv`'s arithmetic (lazy Shoup
products in [0, 2q), a 64-bit sum, one reduction).

Each model must be word-equal (tolerance 0) to JAX's Pallas kernels
`_ntt_keymul_acc` / `_intt_conv_p` (interpret mode, as
tests/test_ks_fused.py runs them) and to the port's plain twins, on a
chain of 3 Q + 2 P 27-bit primes at N = 2^12 in two digits (the last of
one tower) and at its level with one digit; and, on the largest 31-bit
primes (beyond the moduli JAX's Karatsuba kernels take), to the twins and
to JAX's NTT with exact products. Then the conversion's worst case, the
shape-only choice of the staged entries and their registration.
"""

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
from openfhe_tpu_torch.ops.modmatmul import _mod_matmul_rowmod_ref  # noqa
from openfhe_tpu_torch.pke.keyswitch import ks_fused  # noqa: E402
from test_torch_ntt_cluster import (R, _geometry, _kara_moduli,  # noqa
                                    model_fwd, model_inv, round_base)

N = 1 << 12
MASK = np.uint64(0xFFFFFFFF)
U32 = np.uint64(32)


# ---------------------------------------------------------------------------
# the kernels' arithmetic and schedules, in numpy (uint64 words)
# ---------------------------------------------------------------------------

def shoup(x, w, w_sh, q):
    """mul_shoup_q: x w - floor(x w_sh / 2^32) q in 32 bits, in [0, 2q),
    then one conditional subtraction."""
    r = (x * w - ((x * w_sh) >> U32) * q) & MASK
    return np.where(r >= q, r - q, r)


def companion(w, q):
    return (np.asarray(w, np.uint64) << U32) // np.asarray(q, np.uint64)


def fwd_out_word(rank, log_n, log_w):
    """Row word of the first of the R consecutive words each thread of
    block `rank` holds after the forward transform (`fwd_out_word`)."""
    _, t_n, _, lo1 = _geometry(log_n, log_w)
    tid = np.arange(t_n, dtype=np.int64)
    if lo1 == 0:
        return rank * t_n + tid
    return (rank << log_w) + round_base(tid, 0, log_w)


def model_keymul(conv, c2, key, psi, q, kql, alpha, key_shift, log_w):
    """keymul_cluster: conv [nd, rows, N], c2 [kql, N], key (bv, bv_sh, av,
    av_sh) each [>= nd, key_rows, N], psi [rows, N], q [rows] -> ext [2,
    rows, N]."""
    nd, rows, n = conv.shape
    log_n = n.bit_length() - 1
    c = _geometry(log_n, log_w)[0]
    ext = np.zeros((2, rows, n), np.uint64)
    written = np.zeros((rows, n), bool)
    for cluster in range(rows):
        tau = rows - 1 - cluster                 # the P towers first
        qt = q[tau]
        krow = tau if tau < kql else tau + key_shift
        own_digit = tau // alpha if tau < kql else nd
        order = ([(own_digit + 1 + i) % nd for i in range(nd)]
                 if own_digit < nd else list(range(nd)))
        acc = {}
        for i, j in enumerate(order):
            own = j == own_digit
            assert own == (j * alpha <= tau < min((j + 1) * alpha, kql))

            def keymul(rank, a, idx, i=i, j=j):
                assert (idx[:, 0] == fwd_out_word(rank, log_n, log_w)).all()
                a = a[0].astype(np.uint64)
                t = np.stack([shoup(a, key[0][j, krow][idx],
                                    key[1][j, krow][idx], qt),
                              shoup(a, key[2][j, krow][idx],
                                    key[3][j, krow][idx], qt)])
                acc[rank] = t if i == 0 else (acc[rank] + t) % qt
                if i == nd - 1:
                    ext[:, tau, idx] = acc[rank]
                    written[tau, idx] = True

            if own:
                for rank in range(c):
                    idx = fwd_out_word(rank, log_n, log_w)[:, None] \
                        + np.arange(R)
                    keymul(rank, c2[tau][idx][None], idx)
            else:
                model_fwd(conv[j, tau][None].astype(np.int64),
                          psi[tau][None].astype(np.int64),
                          q[tau:tau + 1].astype(np.int64), log_w, keymul)
    assert written.all()
    return ext


def csub(r, q):
    """csub: min(r, r - q) in 32 bits."""
    return np.minimum(r, (r - q) & MASK)


def reduce_wide(x, q, red):
    """reduce_wide: x (uint64 words) mod q with red = (2^32 mod q, its
    companion, floor(2^32 / q)) (a row of `Basis.red64`): hi by a Shoup
    multiply and lo by a Barrett step, each then canonical, and their sum,
    in 32-bit words."""
    r32, r32_sh, m32 = (np.asarray(v, np.uint64) for v in red)
    hi, lo = x >> U32, x & MASK
    t_lo = csub((lo - ((lo * m32) >> U32) * q) & MASK, q)
    return csub((shoup(hi, r32, r32_sh, q) + t_lo) & MASK, q)


def model_pconv(y, w, w_sh, d, red, a_dim, a_total, own=False, splits=1):
    """pconv: y [>= a_total, N] (batch b's rows b a_dim .. b a_dim + rows_b
    - 1, rows_b = min(a_dim, a_total - b a_dim)), w and w_sh [batch, a_dim,
    d] (one table a batch), d [d], red [d, 3] -> [batch, d, N] and the
    64-bit sums: lazy Shoup products, summed, reduced once by
    reduce_wide; with `own` batch b's own rows [b a_dim, b a_dim + rows_b)
    are zero. Block z of `splits` takes its share of the converted rows
    (and of the own rows), as the kernel's blockIdx.z does; every row is
    written exactly once."""
    batch, d_dim = w.shape[0], len(d)
    n = y.shape[-1]
    y = y.astype(np.uint64)
    dd = d.astype(np.uint64)
    out = np.zeros((batch, d_dim, n), np.uint64)
    total = np.zeros((batch, d_dim, n), np.uint64)
    written = np.zeros((batch, d_dim), int)
    for b in range(batch):
        rows = min(a_dim, a_total - b * a_dim)
        assert rows >= 1
        x = y[b * a_dim:b * a_dim + rows]
        own_lo, n_own = b * a_dim, rows if own else 0
        m = d_dim - n_own
        per, per_own = -(-m // splits), -(-n_own // splits)
        for z in range(splits):
            for k in range(z * per_own, min(n_own, (z + 1) * per_own)):
                written[b, own_lo + k] += 1
            for k in range(z * per, min(m, (z + 1) * per)):
                j = k if k < own_lo else k + n_own
                wj = w[b, :rows, j, None].astype(np.uint64)
                wj_sh = w_sh[b, :rows, j, None].astype(np.uint64)
                terms = (x * wj - ((x * wj_sh) >> U32) * dd[j]) & MASK
                total[b, j] = terms.sum(axis=0)
                out[b, j] = reduce_wide(total[b, j], dd[j], red[j])
                written[b, j] += 1
    assert (written == 1).all()
    return out, total


def model_intt_conv_p(ext, tabs, log_w):
    """K45: the inverse cluster transform of row (r / kp) (kql + kp) + kql
    + r % kp of ext into row r of [2 kp, N], times k45_scale, then pconv."""
    kql, kp = tabs.kql, tabs.kp
    n = ext.shape[-1]
    r = np.arange(2 * kp)
    src = (r // kp) * (kql + kp) + kql + r % kp
    tower = r % kp
    u64 = lambda t: mo.to_u32(t).astype(np.int64)
    bp = tabs.basis_p
    pc = model_inv(ext.reshape(-1, n)[src].astype(np.int64),
                   u64(bp.ipsi_br)[tower], np.array(bp.moduli)[tower],
                   u64(tabs.k45_scale).reshape(-1)[tower], log_w)
    w = lambda t: np.broadcast_to(mo.to_u32(t), (2,) + tuple(t.shape))
    bq = tabs.basis_ql
    out, _ = model_pconv(pc, w(tabs.pconv_w), w(tabs.pconv_w_sh),
                         np.array(bq.moduli), mo.to_u32(bq.red64), kp,
                         2 * kp, splits=3)
    return out


# ---------------------------------------------------------------------------
# the chains
# ---------------------------------------------------------------------------

def _rand(rng, moduli, lead=(), n=N):
    q = np.array(moduli, np.uint64).reshape(-1, 1)
    v = rng.integers(0, 1 << 62, size=lead + (len(moduli), n),
                     dtype=np.uint64) % q
    v[..., 0] = q[:, 0] - 1                      # the largest residue
    return v


def _case(mq, mp, kql, num_parts, seed):
    """Port tables, inputs and a 2-digit key for the level with kql of the
    Q towers mq (all of them the full chain)."""
    rng = np.random.default_rng(seed)
    kf = len(mq)
    tabs = ks_fused.make_fused_ks_tables(make_basis(mq[:kql] + mp, N), kql,
                                         kf, num_parts)
    qlp = mq[:kql] + mp
    key_q = np.array(mq + mp, np.uint64).reshape(-1, 1)
    halves = [_rand(rng, mq + mp, (2,)) for _ in range(2)]
    key = (halves[0], companion(halves[0], key_q), halves[1],
           companion(halves[1], key_q))
    return dict(tabs=tabs, qlp=qlp, key=key,
                conv=_rand(rng, qlp, (tabs.nd,)), c2=_rand(rng, mq[:kql]),
                ext=_rand(rng, qlp, (2,)))


def _models(case, log_w):
    t = case["tabs"]
    b = t.basis_qlp
    k3 = model_keymul(case["conv"], case["c2"], case["key"],
                      mo.to_u32(b.psi_br).astype(np.uint64),
                      np.array(b.moduli, np.uint64), t.kql, t.alpha,
                      t.k_q_full - t.kql, log_w)
    return k3, model_intt_conv_p(case["ext"], t, log_w)


def _twins(case):
    t, u = case["tabs"], mo.u32_tensor
    k3 = ks_fused.ntt_keymul_acc(u(case["conv"]), u(case["c2"]),
                                 *(u(k) for k in case["key"]), t)
    return mo.to_u32(k3), mo.to_u32(ks_fused.intt_conv_p(u(case["ext"]), t))


@pytest.fixture(scope="module")
def chain27():
    """3 Q + 2 P 27-bit primes (JAX's Karatsuba kernels take them) in 2
    digits of alpha = 2, at level 0 (kql 3: digit 1 has one tower) and
    level 1 (kql 2: one digit), with JAX's K3 and K45 in interpret mode."""
    mods = _kara_moduli(N, 5)
    mq, mp = mods[:3], mods[3:]
    out = {}
    jks.INTERPRET = True
    try:
        for kql, seed in ((3, 3), (2, 2)):
            case = _case(mq, mp, kql, 2, seed)
            t = case["tabs"]
            jt = jks.make_fused_ks_tables(mq, mp, kql, 2, N, len(mq),
                                          pad_to=None)
            r, c = jt.r, jt.c
            kqlp = kql + len(mp)
            assert (jt.nd, jt.alpha) == (t.nd, t.alpha)
            keys = [jnp.asarray(k.astype(np.uint32)).reshape(
                2, -1, r, c)[:t.nd] for k in case["key"]]
            ext = jks._ntt_keymul_acc(
                jnp.asarray(case["conv"].astype(np.uint32)).reshape(
                    t.nd, kqlp, r, c),
                jnp.asarray(case["c2"].astype(np.uint32)).reshape(kql, r, c),
                *keys, jt)
            convq = jks._intt_conv_p(
                jnp.asarray(case["ext"].astype(np.uint32)).reshape(
                    2, kqlp, r, c), jt)
            case["jax"] = (np.asarray(ext).reshape(2, kqlp, N),
                           np.asarray(convq))
            out[kql] = case
    finally:
        jks.INTERPRET = False
    return out


@pytest.mark.parametrize("kql,log_w", [(3, 12), (3, 10), (2, 9)],
                         ids=["two-digits-C1", "two-digits-C4",
                              "one-digit-C8"])
def test_models_match_jax_kernels_and_twins(chain27, kql, log_w):
    case = chain27[kql]
    assert case["tabs"].nd == (2 if kql == 3 else 1)
    k3, k45 = _models(case, log_w)
    want_k3, want_k45 = case["jax"]
    np.testing.assert_array_equal(k3, want_k3)
    np.testing.assert_array_equal(k45, want_k45)
    twin_k3, twin_k45 = _twins(case)
    np.testing.assert_array_equal(k3, twin_k3)
    np.testing.assert_array_equal(k45, twin_k45)


def _top31(count, n=N):
    mods = [nbtheory.previous_prime(1 << 31, 2 * n)]
    while len(mods) < count:
        mods.append(nbtheory.previous_prime(mods[-1], 2 * n))
    return mods


@pytest.mark.parametrize("log_w", [12, 10])
def test_models_on_31_bit_primes_match_jax_ntt_and_twins(log_w):
    """4 Q + 2 P of the largest 31-bit primes in 2 digits: the models
    against the twins and against JAX's stage transform with exact
    products (s * key mod q, sums of canonical words)."""
    mods = _top31(6)
    case = _case(mods[:4], mods[4:], 4, 2, 31)
    k3, k45 = _models(case, log_w)
    twin_k3, twin_k45 = _twins(case)
    np.testing.assert_array_equal(k3, twin_k3)
    np.testing.assert_array_equal(k45, twin_k45)
    t = case["tabs"]
    q = np.array(mods, np.uint64).reshape(-1, 1)
    kql, alpha = t.kql, t.alpha
    jb = jbasis.make_basis(mods, N)
    want = np.zeros((2, 6, N), np.uint64)
    for j in range(t.nd):
        s = np.asarray(jntt.ntt_fwd(jnp.asarray(
            case["conv"][j].astype(np.uint32)), jb)).astype(np.uint64)
        own = slice(j * alpha, min((j + 1) * alpha, kql))
        s[own] = case["c2"][own]
        for e in range(2):
            want[e] = (want[e] + s * case["key"][2 * e][j] % q) % q
    np.testing.assert_array_equal(k3, want)
    # K45: JAX's inverse transform of the P rows, * (P/p_i)^-1, then the
    # exact conversion
    jp = jbasis.make_basis(mods[4:], N)
    y = np.asarray(jntt.ntt_inv(jnp.asarray(
        case["ext"][:, 4:].astype(np.uint32)), jp)).astype(np.uint64)
    y = y * mo.to_u32(t.pscale).astype(np.uint64) % q[4:]
    w = mo.to_u32(t.pconv_w).astype(np.uint64)
    conv = sum(y[:, i, None, :] * w[i, :, None] % q[:4]
               for i in range(2)) % q[:4]
    np.testing.assert_array_equal(k45, conv)


@pytest.mark.parametrize("a_dim,digits", [(16, 1), (64, 1), (16, 2)],
                         ids=["P16", "P64", "digits-16+14"])
def test_conversion_arithmetic_worst_case(a_dim, digits):
    """pconv's lazy products and 64-bit sum at the largest 31-bit primes,
    every input word and weight q - 1 (and the real weights: the mod-down's
    of a P of a_dim towers, or K2's per-digit ones at two digits of 16 and
    14 rows, own rows zero): equal to the plain conversion, with sums past
    2^32, so a 32-bit sum would overflow."""
    n = 8
    mods = _top31(a_dim + 31, 1 << 16)
    mp, mq = mods[:a_dim], mods[a_dim:]
    d = np.array(mq, np.uint64)
    red = mo.to_u32(make_basis(mq, n).red64)
    if digits == 1:
        # K45: both elements through the P -> Q weights
        y = np.broadcast_to(np.array(mp, np.uint64)[:, None] - 1,
                            (a_dim, n))
        y = np.concatenate([y, y])
        big_p = int(np.prod([int(p) for p in mp], dtype=object))
        weights = [np.broadcast_to(d - 1, (a_dim, len(mq))).copy(),
                   np.array([[big_p // p % q for q in mq] for p in mp],
                            np.uint64)]
        for w in weights:
            ws = np.stack([w, w])
            got, total = model_pconv(y, ws, companion(ws, d), d, red, a_dim,
                                     2 * a_dim, splits=4)
            want = _mod_matmul_rowmod_ref(
                mo.u32_tensor(y.reshape(2, a_dim, n)), mo.u32_tensor(w),
                mo.u32_tensor(d))
            np.testing.assert_array_equal(got, mo.to_u32(want))
            assert total.max() > MASK
        # the port's mod-down weights for that P are the ones modelled
        tabs = ks_fused.make_fused_ks_tables(make_basis(mq + mp, n),
                                             len(mq), len(mq), 1)
        np.testing.assert_array_equal(mo.to_u32(tabs.pconv_w), weights[1])
        return
    # K2 at level 1's shape: 30 Q of a 31-tower chain in two digits of 16
    # and 14 rows, extended to 30 + a_dim towers, inputs q - 1
    qlp = mq[:30] + mp
    tabs = ks_fused.make_fused_ks_tables(make_basis(qlp, n), 30, 31, 2)
    assert (tabs.nd, tabs.alpha) == (2, 16)
    dq = np.array(qlp, np.uint64)
    y = np.broadcast_to(dq[:30, None] - 1, (30, n)).copy()
    got, total = model_pconv(y, mo.to_u32(tabs.conv_w),
                             mo.to_u32(tabs.conv_w_sh), dq,
                             mo.to_u32(tabs.basis_qlp.red64), 16, 30,
                             own=True, splits=3)
    want = ks_fused.conv_digits(mo.u32_tensor(y), tabs)
    np.testing.assert_array_equal(got, mo.to_u32(want))
    assert total.max() > MASK
    assert not got[0, :16].any() and not got[1, 16:30].any()


# ---------------------------------------------------------------------------
# the entries and their choice
# ---------------------------------------------------------------------------

def test_staged_forms_serve_other_rings_by_shape(monkeypatch):
    """The cluster entries for 2^4 <= N <= 2^17, the staged ones for
    every other ring; the choice reads the ring alone."""
    calls = []
    monkeypatch.setattr(ks_fused, "_ntt_keymul_acc_cu",
                        lambda *a: calls.append((a[-2].basis_qlp.ring_dim,
                                                 a[-1])))
    monkeypatch.setattr(ks_fused, "_intt_conv_p_cu",
                        lambda ext, t, entry: calls.append(
                            (t.basis_qlp.ring_dim, entry)))
    want = []
    for log_n in (3, 4, 13, 16, 17, 18):
        n = 1 << log_n
        mods = [nbtheory.first_prime(bits, 2 * n) for bits in (30, 31)]
        tabs = ks_fused.make_fused_ks_tables(make_basis(mods, n), 1, 1, 1)
        x = torch.empty((1, 2, n), dtype=torch.int32, device="meta")
        ks_fused.ntt_keymul_acc(x, x, x, x, x, x, tabs)
        ks_fused.intt_conv_p(x, tabs)
        ks_fused.ntt_keymul_acc_staged(x, x, x, x, x, x, tabs)
        ks_fused.intt_conv_p_staged(x, tabs)
        form = "" if 4 <= log_n <= 17 else "_staged"
        want += [(n, "ntt_keymul_acc" + form), (n, "intt_conv_p" + form),
                 (n, "ntt_keymul_acc_staged"), (n, "intt_conv_p_staged")]
    assert calls == want


def test_staged_entries_are_registered():
    """Every former form is an entry point of ks_fused.cu's library, with
    the argtypes its wrapper passes."""
    src = _build.SOURCES["ks_fused"]
    p, i = _build._P, _build._I
    assert src["ntt_keymul_acc_staged"] == [p] * 11 + [i] * 6 + [p]
    assert src["ntt_keymul_acc"] == [p] * 10 + [i] * 6 + [p]
    # the cluster form also reads the Q_l towers' Basis.red64
    assert src["intt_conv_p"] == [p] * 12 + [i] * 3 + [p]
    assert src["intt_conv_p_staged"] == [p] * 11 + [i] * 3 + [p]
    # K6f: the staged form takes scratch where the cluster form takes red
    assert src["ntt_submul_final"] == [p] * 13 + [i] * 4 + [p]
    assert src["ntt_submul_final_staged"] == src["ntt_submul_final"]
    # K2: y in place with red64 and kql, or the padded digits
    assert src["conv_digits"] == [p] * 6 + [i] * 5 + [p]
    assert src["conv_digits_rowmod"] == [p] * 5 + [i] * 4 + [p]
