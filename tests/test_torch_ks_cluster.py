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


def model_pconv(y, w, w_sh, d):
    """pconv: y [B, a, N], w and w_sh [a, d], d [d] -> [B, d, N]: lazy
    Shoup products summed in 64 bits, then (hi 2^32 + lo) mod d by two
    Shoup multiplies."""
    y = y.astype(np.uint64)[:, :, None, :]
    w, w_sh = w[None, :, :, None], w_sh[None, :, :, None]
    dd = d.astype(np.uint64)[None, None, :, None]
    total = ((y * w - ((y * w_sh) >> U32) * dd) & MASK).sum(axis=1)
    d = d.astype(np.uint64)[None, :, None]
    c = (np.uint64(1) << U32) % d
    hi, lo = total >> U32, total & MASK
    r_lo = (lo - ((lo * ((np.uint64(1) << U32) // d)) >> U32) * d) & MASK
    r = shoup(hi, c, companion(c, d), d) + np.where(r_lo >= d, r_lo - d,
                                                     r_lo)
    return np.where(r >= d, r - d, r), total


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
    out, _ = model_pconv(pc.reshape(2, kp, n), mo.to_u32(tabs.pconv_w),
                         mo.to_u32(tabs.pconv_w_sh),
                         np.array(tabs.basis_ql.moduli))
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


@pytest.mark.parametrize("a_dim", [16, 64])
def test_conversion_arithmetic_worst_case(a_dim):
    """pconv's lazy products and 64-bit sum at the largest 31-bit primes,
    every input word and weight q - 1 (and the real mod-down weights of a
    16-tower P): equal to the plain conversion, with sums past 2^32, so a
    32-bit sum would overflow."""
    n = 8
    mods = _top31(a_dim + 31, 1 << 16)
    mp, mq = mods[:a_dim], mods[a_dim:]
    d = np.array(mq, np.uint64)
    y = np.broadcast_to(np.array(mp, np.uint64)[None, :, None] - 1,
                        (2, a_dim, n)).copy()
    big_p = int(np.prod([int(p) for p in mp], dtype=object))
    weights = [np.broadcast_to(d - 1, (a_dim, len(mq))).copy(),
               np.array([[big_p // p % q for q in mq] for p in mp],
                        np.uint64)]
    for w in weights:
        got, total = model_pconv(y, w, companion(w, d[None, :]), d)
        want = _mod_matmul_rowmod_ref(mo.u32_tensor(y), mo.u32_tensor(w),
                                      mo.u32_tensor(d))
        np.testing.assert_array_equal(got, mo.to_u32(want))
        assert total.max() > MASK
    # the port's mod-down weights for that P are the ones modelled
    tabs = ks_fused.make_fused_ks_tables(make_basis(mq + mp, n), len(mq),
                                         len(mq), 1)
    np.testing.assert_array_equal(mo.to_u32(tabs.pconv_w), weights[1])


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
    src = _build.SOURCES["ks_fused"]
    assert src["ntt_keymul_acc_staged"] == [_build._P] * 11 + [_build._I] * 6 \
        + [_build._P]
    assert src["ntt_keymul_acc"] == [_build._P] * 10 + [_build._I] * 6 \
        + [_build._P]
    assert src["intt_conv_p_staged"] == src["intt_conv_p"]
