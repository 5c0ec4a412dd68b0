"""The cluster NTT of `csrc/ntt_cluster.cuh` (`ops/ntt.py`), on the CPU.

There is no card here, so the kernel's schedule is modelled in numpy from
the kernel's own index formulas: cluster rank, column range, the cross-
block step's words and twiddles, each register round's slot -> word and
twiddle indices (`round_base`), and the shared-memory swizzle (`phys`).
With the words a block holds as a parameter, the model runs at N = 2^14
with clusters of 1, 2 and 4 blocks and at N = 2^13 with 8, and each case
must be word-equal (tolerance 0) to JAX's stage transform and to the
port's plain twins, on 26-, 27- and 31-bit primes; at N = 2^14 with
27-bit moduli also to JAX's own kernel `ntt_fwd_fused` / `ntt_inv_fused`
in interpret mode. Then the geometry the wrapper and `chip_smoke.py` read,
and the wrappers' refusals off the CPU.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openfhe_tpu.lattice import basis as jbasis  # noqa: E402
from openfhe_tpu.math import nbtheory  # noqa: E402
from openfhe_tpu.ops import kara, ntt_fused  # noqa: E402
from openfhe_tpu.ops import ntt as jntt  # noqa: E402
from openfhe_tpu_torch import _build  # noqa: E402
from openfhe_tpu_torch.lattice.basis import make_basis  # noqa: E402
from openfhe_tpu_torch.math import modops as mo  # noqa: E402
from openfhe_tpu_torch.ops import ntt  # noqa: E402

LOG_R = ntt.CLUSTER_LOG_THREAD_WORDS
R = 1 << LOG_R
SWIZZLE_LOG = 10


# ---------------------------------------------------------------------------
# the kernel's schedule, in numpy (names and formulas of ntt_cluster.cuh)
# ---------------------------------------------------------------------------

def phys(i, log_w):
    """Shared-memory word of tile index i: bits 0-4 XORed with bits 5-9,
    or with bits 4-8 in a tile of fewer than 2^SWIZZLE_LOG words."""
    return i ^ ((i >> 5) & 31) if log_w >= SWIZZLE_LOG else i ^ ((i >> 4) & 31)


def round_base(tid, lo, log_w):
    """Tile index of slot 0 of each thread in a round with slot bits
    [lo, lo + LOG_R)."""
    slots = (R - 1) << lo
    base = np.zeros_like(tid)
    taken = slots
    if log_w >= SWIZZLE_LOG:
        for lane in range(5):
            pos = lane + 5 if slots >> lane & 1 else lane
            base |= (tid >> lane & 1) << pos
            taken |= 1 << pos
        tid = tid >> 5
    for pos in range(log_w):
        if not taken >> pos & 1:
            base |= (tid & 1) << pos
            tid = tid >> 1
    return base


def _tw_at(rb):
    """Register slot of the first twiddle of a round's stage rb
    (`Twiddles`: kAt = 2^(kLogR - 1 - rb) - 1)."""
    return (1 << (LOG_R - 1 - rb)) - 1


def _stages(a, x0, lo, rb_lo, rb_hi, log_n, psi, q, inverse):
    """The stages of spans 2^(lo + rb), rb in [rb_lo, rb_hi] (forward from
    rb_hi down, inverse from rb_lo up), on slots a [rows, T, R] whose slot
    0 is global word x0 [T]: `load_twiddles` puts slot group h of stage rb,
    psi[N / 2t + (x0 >> (b + 1)) + h], in register slot kAt + h of the
    round's R - 1, and the butterflies read it back from there."""
    tw = np.full(a.shape[:-1] + (R - 1,), -1, np.int64)
    for rb in range(rb_lo, rb_hi + 1):
        b = lo + rb
        t0 = (1 << (log_n - 1 - b)) + (x0 >> (b + 1))
        for h in range(R >> (rb + 1)):
            assert (tw[..., _tw_at(rb) + h] == -1).all()   # one stage a slot
            tw[..., _tw_at(rb) + h] = psi[:, t0 + h]
    order = range(rb_lo, rb_hi + 1) if inverse else range(rb_hi, rb_lo - 1, -1)
    for rb in order:
        for h in range(R >> (rb + 1)):
            w = tw[..., _tw_at(rb) + h]
            for lane in range(1 << rb):
                s = (h << (rb + 1)) | lane
                u, v = a[..., s], a[..., s + (1 << rb)]
                if inverse:
                    a[..., s], a[..., s + (1 << rb)] = (
                        (u + v) % q, (u - v) % q * w % q)
                else:
                    v = v * w % q
                    a[..., s], a[..., s + (1 << rb)] = (u + v) % q, (u - v) % q


def _geometry(log_n, log_w):
    """(C, threads a block, kP, kLo1) of `Geometry`: step 1's slots are the
    global index bits [kLo1, kLo1 + LOG_R), the C bits that pick the block
    and the tile's top kP = LOG_R - log2(C)."""
    log_c = log_n - log_w
    kp = LOG_R - log_c
    return 1 << log_c, 1 << (log_w - LOG_R), kp, log_w - kp


def inv_round_lo(lo_b, top):
    return lo_b if lo_b + LOG_R <= top else (top - LOG_R if top > LOG_R
                                             else 0)


def inv_round_hi(lo_b, top):
    return min(lo_b + LOG_R, top)


def model_fwd(x, psi, q, log_w, epilogue=None):
    """fwd_cluster on rows x [rows, N] (int64) with per-row twiddles psi
    [rows, N] and moduli q [rows]: returns the output words. The words
    each thread holds at the end go to `epilogue(rank, a, idx)` (the hook
    of `fwd_cluster_row`: a [rows, T, R] and their row words idx [T, R],
    consecutive in each thread), by default stored at idx."""
    rows, n = x.shape
    log_n = n.bit_length() - 1
    c, t_n, kp, lo1 = _geometry(log_n, log_w)
    q = q[:, None]
    tid = np.arange(t_n, dtype=np.int64)
    slots = np.arange(R, dtype=np.int64)
    tiles = np.zeros((rows, c, 1 << log_w), np.int64)
    out = np.empty_like(x)

    def store(rank, a, idx):
        out[:, idx] = a

    epilogue = epilogue or store
    # 1. block r's threads: slot s is word j + (s << kLo1), j = r T + tid;
    # the cross-block stages and the tile's top kP, then slot (i, p) to
    # word j + (p << kLo1) of block i's tile
    for rank in range(c):
        j = rank * t_n + tid
        idx = j[:, None] + (slots << lo1)[None, :]
        a = x[:, idx]
        _stages(a, j, lo1, 0, LOG_R - 1, log_n, psi, q, False)
        if lo1 == 0:
            epilogue(rank, a, idx)
            continue
        for s in range(R):
            i, p = s >> kp, s & ((1 << kp) - 1)
            tiles[:, i, phys(j ^ (p << lo1), log_w)] = a[..., s]
    # 2. each block's tile, LOG_R stages a round from bit kLo1 - 1 down;
    # 3. the last round writes its consecutive words
    for rank in range(c if lo1 else 0):
        x_tile = rank << log_w
        hi = lo1 - 1
        while True:
            lo = hi - LOG_R + 1 if hi >= LOG_R else 0
            base = round_base(tid, lo, log_w)
            idx = base[:, None] | (slots << lo)[None, :]
            a = tiles[:, rank][:, phys(idx, log_w)]
            _stages(a, x_tile + base, lo, 0, hi - lo, log_n, psi, q, False)
            if lo == 0:
                assert (idx == base[:, None] + slots).all()
                epilogue(rank, a, x_tile + idx)
                break
            tiles[:, rank][:, phys(idx, log_w)] = a
            hi = lo - 1
    return out


def model_inv(x, ipsi, q, ninv, log_w, load=None):
    """inv_cluster, as model_fwd; ninv [rows]. Each thread's R consecutive
    input words come from `load(rank, idx)` (the hook of
    `inv_cluster_row`: idx [T, R] their row words, consecutive in each
    thread; it returns a [rows, T, R]), by default read from x."""
    rows, n = x.shape
    load = load or (lambda rank, idx: x[:, idx])
    log_n = n.bit_length() - 1
    c, t_n, kp, lo1 = _geometry(log_n, log_w)
    q = q[:, None]
    tid = np.arange(t_n, dtype=np.int64)
    slots = np.arange(R, dtype=np.int64)
    tiles = np.zeros((rows, c, 1 << log_w), np.int64)
    # 1. each block's tile, LOG_R stages a round from bit 0 up to kLo1;
    # the first reads its consecutive words
    for rank in range(c):
        x_tile = rank << log_w
        lo_b = 0
        while lo_b < lo1:
            lo, hi = inv_round_lo(lo_b, lo1), inv_round_hi(lo_b, lo1)
            base = round_base(tid, lo, log_w)
            idx = base[:, None] | (slots << lo)[None, :]
            if lo_b == 0:
                assert (idx == base[:, None] + slots).all()
                a = load(rank, x_tile + idx)
            else:
                a = tiles[:, rank][:, phys(idx, log_w)]
            _stages(a, x_tile + base, lo, lo_b - lo, hi - 1 - lo, log_n,
                    ipsi, q, True)
            tiles[:, rank][:, phys(idx, log_w)] = a
            lo_b = hi
    # 2. block r gathers word j + (p << kLo1) of block i's tile into slot
    # (i, p), runs the tile's top kP stages and the cross-block ones, then
    # N^-1
    out = np.empty_like(x)
    for rank in range(c):
        j = rank * t_n + tid
        idx = j[:, None] + (slots << lo1)[None, :]
        if lo1 == 0:
            a = load(rank, idx)
        else:
            a = np.empty((rows, t_n, R), np.int64)
            for s in range(R):
                i, p = s >> kp, s & ((1 << kp) - 1)
                a[..., s] = tiles[:, i, phys(j ^ (p << lo1), log_w)]
        _stages(a, j, lo1, 0, LOG_R - 1, log_n, ipsi, q, True)
        out[:, idx] = a * ninv[:, None, None] % q[..., None]
    return out


# ---------------------------------------------------------------------------
# the model against JAX and the plain twins
# ---------------------------------------------------------------------------

def _moduli(n):
    return [nbtheory.first_prime(bits, 2 * n) for bits in (26, 27, 31)]


def _kara_moduli(n, count):
    """27-bit moduli (<= kara.MAX_MOD) for JAX's fused kernel, as
    tests/test_ntt_fused.py picks them."""
    mods, a = [], kara.MAX_MOD // (2 * n)
    while len(mods) < count:
        q = a * 2 * n + 1
        if q <= kara.MAX_MOD and nbtheory.is_prime(q):
            mods.append(q)
        a -= 1
    return mods


def _run_model(x, moduli, n, log_w):
    """The model's forward and inverse of x [B, k, N] (uint32)."""
    tb = make_basis(moduli, n)
    k = len(moduli)
    rows = x.reshape(-1, n).astype(np.int64)
    tower = np.arange(rows.shape[0]) % k
    u64 = lambda t: mo.to_u32(t).astype(np.int64)
    q = np.array(moduli, np.int64)[tower]
    fwd = model_fwd(rows, u64(tb.psi_br)[tower], q, log_w)
    inv = model_inv(rows, u64(tb.ipsi_br)[tower], q,
                    u64(tb.ninv).reshape(-1)[tower],
                    log_w)
    return fwd.reshape(x.shape), inv.reshape(x.shape), tb


# (N, words a block): clusters of 1, 2 (the kernel's geometry at this N),
# 4 at N = 2^14 and 8 at N = 2^13
CASES = [(1 << 14, 1 << 14), (1 << 14, 1 << 13), (1 << 14, 1 << 12),
         (1 << 13, 1 << 10)]


@pytest.mark.parametrize("n,words", CASES,
                         ids=[f"N{n}-C{n // w}" for n, w in CASES])
def test_schedule_model_matches_jax(n, words):
    moduli = _moduli(n)
    x = np.random.default_rng(n + words).integers(
        0, 1 << 62, size=(2, 3, n), dtype=np.uint64)
    x = (x % np.array(moduli, np.uint64)[:, None]).astype(np.uint32)
    x[..., 0] = np.array(moduli, np.uint32) - 1     # the largest residue
    fwd, inv, tb = _run_model(x, moduli, n, words.bit_length() - 1)
    jb = jbasis.make_basis(moduli, n)
    want_fwd = np.asarray(jntt.ntt_fwd(jnp.asarray(x), jb))
    want_inv = np.asarray(jntt.ntt_inv(jnp.asarray(x), jb))
    np.testing.assert_array_equal(fwd, want_fwd)
    np.testing.assert_array_equal(inv, want_inv)
    xt = mo.u32_tensor(x)
    np.testing.assert_array_equal(fwd, mo.to_u32(ntt._ntt_fwd_ref(xt, tb)))
    np.testing.assert_array_equal(inv, mo.to_u32(ntt._ntt_inv_ref(xt, tb)))


@pytest.fixture(scope="module")
def fused14():
    """JAX's fused kernel (interpret mode) on 3 rows of 27-bit moduli at
    N = 2^14, the smallest ring it serves."""
    n = 1 << 14
    moduli = _kara_moduli(n, 3)
    jb = jbasis.make_basis(moduli, n)
    rng = np.random.default_rng(14)
    x = (rng.integers(0, 1 << 62, size=(1, 3, n), dtype=np.uint64)
         % np.array(moduli, np.uint64)[:, None]).astype(np.uint32)
    want_fwd = np.asarray(ntt_fused.ntt_fwd_fused(jnp.asarray(x), jb,
                                                  interpret=True))
    want_inv = np.asarray(ntt_fused.ntt_inv_fused(jnp.asarray(x), jb,
                                                  interpret=True))
    return x, moduli, want_fwd, want_inv


@pytest.mark.parametrize("log_c", [0, 1, 2])
def test_schedule_model_matches_jax_fused_kernel(fused14, log_c):
    x, moduli, want_fwd, want_inv = fused14
    fwd, inv, _ = _run_model(x, moduli, 1 << 14, 14 - log_c)
    np.testing.assert_array_equal(fwd, want_fwd)
    np.testing.assert_array_equal(inv, want_inv)


def test_round_base_covers_each_tile_once_without_bank_conflicts():
    """Every round's (thread, slot) -> index map is a bijection on the
    tile, and each warp's lanes (32, or the block's threads when fewer)
    hit as many banks for every slot, both swizzles."""
    for log_w in (4, 7, 8, 9, 10, 13, 14):
        tid = np.arange(1 << (log_w - LOG_R))
        lanes = min(32, tid.size)
        for lo in range(log_w - LOG_R + 1):
            idx = round_base(tid, lo, log_w)[:, None] | (
                np.arange(R) << lo)[None, :]
            assert np.array_equal(np.sort(idx.ravel()),
                                  np.arange(1 << log_w))
            banks = phys(idx, log_w).reshape(-1, lanes, R) % 32
            assert all(len(set(banks[w, :, s])) == lanes
                       for w in range(banks.shape[0]) for s in range(R))


# ---------------------------------------------------------------------------
# geometry and the wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log_n", range(12, 18))
def test_cluster_geometry(log_n):
    n = 1 << log_n
    ctas, words, smem = ntt.cluster_geometry(n)
    assert ctas * words == n and ctas <= 8 and ctas & (ctas - 1) == 0
    assert smem == 4 * words <= 227 * 1024
    assert words // (1 << LOG_R) <= 1024       # threads a block
    # 2^13 words a block up to N = 2^16, then N / 8
    assert words == min(n, max(1 << 13, n // 8))


def test_geometry_constants_match_the_kernel_source():
    """ops/ntt.py's geometry and this model's swizzle are the constants
    the kernel is compiled with."""
    src = (Path(ntt.__file__).resolve().parents[1] / "csrc"
           / "ntt_cluster.cuh").read_text()
    const = {name: int(v) for name, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kClusterLogW"] == ntt.CLUSTER_LOG_WORDS
    assert const["kLogR"] == ntt.CLUSTER_LOG_THREAD_WORDS
    assert const["kMaxLogC"] == ntt.CLUSTER_MAX_LOG_CTAS
    assert const["kMaxClusterLogN"] == ntt.CLUSTER_MAX_LOG_N
    assert const["kSwizzleLog"] == SWIZZLE_LOG


def test_staged_transform_serves_other_rings_by_shape():
    """Rings the cluster cannot hold (N > 2^17), and below 16 words, go to
    the staged entry points; the choice reads the ring alone."""
    for n in (1 << 18, 1 << 20, 8):
        assert ntt.cluster_geometry(n) is None
    assert ntt.cluster_geometry(1 << 4) == (1, 16, 64)
    calls = []
    record = lambda x, b, entry: calls.append((b.ring_dim, entry))
    orig = ntt._ntt_fwd_launch, ntt._ntt_inv_launch
    ntt._ntt_fwd_launch = ntt._ntt_inv_launch = record
    try:
        for log_n in (4, 13, 16, 17, 18):
            b = make_basis([nbtheory.first_prime(31, 2 << log_n)],
                           1 << log_n)
            ntt._ntt_fwd_cu(None, b)
            ntt._ntt_inv_cu(None, b)
    finally:
        ntt._ntt_fwd_launch, ntt._ntt_inv_launch = orig
    assert calls == [(16, "ntt_fwd"), (16, "ntt_inv"),
                     (1 << 13, "ntt_fwd"), (1 << 13, "ntt_inv"),
                     (1 << 16, "ntt_fwd"), (1 << 16, "ntt_inv"),
                     (1 << 17, "ntt_fwd"), (1 << 17, "ntt_inv"),
                     (1 << 18, "ntt_fwd_staged"),
                     (1 << 18, "ntt_inv_staged")]


def test_staged_entry_points_are_registered():
    assert set(_build.SOURCES["ntt"]) == {
        "ntt_fwd", "ntt_inv", "ntt_fwd_staged", "ntt_inv_staged"}
    assert (_build.SOURCES["ntt"]["ntt_fwd_staged"]
            == _build.SOURCES["ntt"]["ntt_fwd"])
    assert (_build.SOURCES["ntt"]["ntt_inv_staged"]
            == _build.SOURCES["ntt"]["ntt_inv"])


@pytest.mark.parametrize("log_n", [13, 16, 18])
def test_wrappers_take_no_fallback_off_the_cpu(monkeypatch, log_n):
    """On a device without a kernel every wrapper raises, and the plain
    twins are never reached off the CPU."""
    n = 1 << log_n
    tb = make_basis([nbtheory.first_prime(31, 2 * n)], n)

    def twin(*_):
        raise AssertionError("plain twin reached off the CPU")

    monkeypatch.setattr(ntt, "_ntt_fwd_ref", twin)
    monkeypatch.setattr(ntt, "_ntt_inv_ref", twin)
    x = torch.empty((2, 1, n), dtype=torch.int32, device="meta")
    for fn in (ntt.ntt_fwd, ntt.ntt_inv, ntt._ntt_fwd_cu, ntt._ntt_inv_cu,
               ntt._ntt_fwd_staged_cu, ntt._ntt_inv_staged_cu):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fn(x, tb)
