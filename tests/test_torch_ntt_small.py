"""Kernel m (the port's `ops/ntt_small.py`, `csrc/ntt_small.cu`) on the CPU.

`_ntt_small_fwd_ref` / `_ntt_small_inv_ref` are the dense-matrix
formulation of the TPU kernel `openfhe_tpu/ops/ntt_small.py::_mat_call`;
on the card `chip_smoke.py` holds the butterfly kernel against them. Here
they must equal, word for word (tolerance 0), the JAX package's
`ntt_fwd_mat` / `ntt_inv_mat` run through their plain reference
(`force_ref=True`) and its stage loop `_ntt_fwd_vpu` / `_ntt_inv_vpu`, on
inputs drawn from a seeded numpy generator.

There is no card here, so the kernel's schedule is modelled in numpy from
its own index formulas (those of `ntt_cluster.cuh`, whose model
`tests/test_torch_ntt_cluster.py` holds): a group of N / 16 threads a
row; the row copied word by word into one of the group's two buffers at
`phys(i)`; the forward's register rounds from the top index bits down
(`round_base`), the last writing its 16 consecutive words a thread back,
then the row stored a word a lane; the inverse's from the bottom up, then
the top round and N^-1; each twiddle
read from the block's copy of the tower's table, stored at
`phys<kSwizzleLog>(i)`; the grid of `launch_geometry`. Every shared-memory
access the model makes is checked for bank conflicts over the block's
warps. The model must equal JAX and the plain versions word for word at
N = 128 ... 2048 on 1 to 4 towers of 27- and 31-bit primes.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openfhe_tpu.lattice.basis import make_basis as jmake_basis  # noqa: E402
from openfhe_tpu.math.nbtheory import first_prime, next_prime  # noqa: E402
from openfhe_tpu.ops import ntt_small as jntt_small  # noqa: E402
from openfhe_tpu.ops.ntt import _ntt_fwd_vpu, _ntt_inv_vpu  # noqa: E402
from openfhe_tpu_torch.lattice.basis import make_basis  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32, u32_tensor  # noqa: E402
from openfhe_tpu_torch.ops import ntt, ntt_small  # noqa: E402
from test_torch_ntt_cluster import (LOG_R, R, SWIZZLE_LOG, _tw_at,  # noqa
                                    inv_round_hi, inv_round_lo, phys,
                                    round_base)

H100_SMS = 132


def _moduli(n, k, bits=27):
    qs = []
    q = first_prime(bits, 2 * n)
    for _ in range(k):
        qs.append(q)
        q = next_prime(q, 2 * n)
    return qs


def _rand(rng, moduli, n, rows):
    x = rng.integers(0, min(moduli), (rows, len(moduli), n)).astype(np.uint32)
    x[0, :, 0] = min(moduli) - 1            # the largest common residue
    return x


# ---------------------------------------------------------------------------
# the kernel's schedule, in numpy (names and formulas of ntt_small.cu and
# ntt_cluster.cuh)
# ---------------------------------------------------------------------------

def phys_tw(i):
    """Shared-memory word of twiddle i (`phys<kSwizzleLog>`)."""
    return phys(i, SWIZZLE_LOG)


def check_banks(addr):
    """One access by a block's threads (addr [threads], thread order): the
    distinct words each warp reads fall in distinct banks."""
    addr = np.asarray(addr).ravel()
    for w in range(0, addr.size, 32):
        words = np.unique(addr[w:w + 32])
        assert np.unique(words % 32).size == words.size, addr[w:w + 32]


class Block:
    """One block of `groups` groups at ring 2^log_n: shared memory holds
    the tower's twiddles and companions ([0, 2N)), then each group's
    region of two row buffers, kThreads words longer where groups share a
    warp (`Group::kRegion`). Every data or twiddle position the model
    takes goes through `data` / `twiddle`, which check the access's banks
    over all the block's threads."""

    def __init__(self, log_n, groups):
        self.log_n, self.n = log_n, 1 << log_n
        self.t = self.n >> LOG_R                 # threads a group
        self.lo1 = log_n - LOG_R
        self.tid = np.arange(self.t)
        region = 2 * self.n + (self.t if self.t < 32 else 0)
        self.groups = groups
        self.start = 2 * self.n + region * np.arange(groups)[:, None]

    def data(self, idx, buf=0):
        """Positions in a group's buffer of tile indices idx [T] (one per
        thread of the group, one access)."""
        pos = phys(idx, self.log_n)
        check_banks(self.start + buf * self.n + pos[None, :])
        return pos

    def twiddle(self, t0, h):
        """Positions of twiddle t0 + h [T]: phys(t0) ^ h, which needs the
        bits of h clear in t0; every group reads the same."""
        assert not (t0 & h).any() and h < 32
        pos = phys_tw(t0) ^ h
        assert (pos == phys_tw(t0 + h)).all()
        check_banks(np.tile(pos, self.groups))
        return pos

    def copies(self, x, buf=0):
        """The row's copy into a buffer: thread t copies words t + v T."""
        tile = np.empty_like(x)
        for v in range(R):
            i = self.tid + v * self.t
            tile[:, self.data(i, buf)] = x[:, i]
        return tile

    def staged_twiddles(self, psi, threads):
        """The block's copy of the tower's table: thread b copies words
        b + v * threads to phys_tw."""
        s = np.empty_like(psi)
        for v in range(-(-self.n // threads)):
            i = np.arange(v * threads, min(self.n, (v + 1) * threads))
            check_banks(phys_tw(i))
            s[:, phys_tw(i)] = psi[:, i]
        return s


def _stages(a, x0, lo, rb_lo, rb_hi, blk, s_tw, q, inverse):
    """`load_twiddles` (through the block's table) and the butterflies of
    the stages of spans 2^(lo + rb), rb in [rb_lo, rb_hi], on slots a
    [rows, T, R] whose slot 0 is row word x0 [T]."""
    tw = np.full(a.shape[:-1] + (R - 1,), -1, np.int64)
    for rb in range(rb_lo, rb_hi + 1):
        b = lo + rb
        t0 = (1 << (blk.log_n - 1 - b)) + (x0 >> (b + 1))
        for h in range(R >> (rb + 1)):
            assert (tw[..., _tw_at(rb) + h] == -1).all()   # one stage a slot
            tw[..., _tw_at(rb) + h] = s_tw[:, blk.twiddle(t0, h)]
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


def model_fwd(x, s_tw, q, blk, buf=0):
    """The forward of rows x [rows, N] (int64) of one tower, s_tw the
    block's copy of its twiddles, q [rows, 1, 1]: `fwd_rounds` from index
    bit log_n - 1 down over the buffer, the first round's twiddles loaded
    at x0 = the thread's index, the last round's 16 consecutive words a
    thread written back where they were read; then thread t stores words
    t + v T."""
    tile = blk.copies(x, buf)
    out = np.full_like(x, -1)
    slots = np.arange(R)
    hi = blk.log_n - 1
    while True:
        lo = hi - LOG_R + 1 if hi >= LOG_R else 0
        base = round_base(blk.tid, lo, blk.log_n)
        if hi == blk.log_n - 1:
            assert (base == blk.tid).all()      # the twiddles' x0
        idx = base[:, None] | (slots << lo)[None, :]
        pos = np.stack([blk.data(idx[:, s], buf) for s in range(R)], 1)
        a = tile[:, pos]
        _stages(a, base, lo, 0, hi - lo, blk, s_tw, q, False)
        tile[:, pos] = a
        if lo == 0:
            assert (idx == base[:, None] + slots).all()
            assert (pos == phys(base, blk.log_n)[:, None] ^ slots).all()
            break
        hi = lo - 1
    for v in range(R):
        i = blk.tid + v * blk.t
        out[:, i] = tile[:, blk.data(i, buf)]
    return out


def model_inv(x, s_tw, q, ninv, blk, buf=0):
    """The inverse (`inv_cluster_row` on the group): `inv_rounds` from
    index bit 0 up to kLo1 over the buffer, the first round's 16
    consecutive words a thread read by the load hook at phys(x0) ^ s; then
    the top kLogR stages on words t + (s << kLo1) and N^-1, stored."""
    tile = blk.copies(x, buf)
    slots = np.arange(R)
    lo_b = 0
    while lo_b < blk.lo1:
        lo, hi = inv_round_lo(lo_b, blk.lo1), inv_round_hi(lo_b, blk.lo1)
        base = round_base(blk.tid, lo, blk.log_n)
        idx = base[:, None] | (slots << lo)[None, :]
        pos = np.stack([blk.data(idx[:, s], buf) for s in range(R)], 1)
        if lo_b == 0:
            assert (idx == base[:, None] + slots).all()
            hook = phys(base, blk.log_n)[:, None] ^ slots[None, :]
            assert (pos == hook).all()
        a = tile[:, pos]
        _stages(a, base, lo, lo_b - lo, hi - 1 - lo, blk, s_tw, q, True)
        tile[:, pos] = a
        lo_b = hi
    idx = blk.tid[:, None] + (slots << blk.lo1)[None, :]
    pos = np.stack([blk.data(idx[:, s], buf) for s in range(R)], 1)
    a = tile[:, pos]
    _stages(a, blk.tid, blk.lo1, 0, LOG_R - 1, blk, s_tw, q, True)
    out = np.full_like(x, -1)
    out[:, idx] = a * ninv % q
    return out


def grid_rows(rows, k, n, sms):
    """The rows each group takes, in order: {(tower, block, group):
    [row, ...]} over the launch of `launch_geometry`, and (blocks,
    groups a block)."""
    polys = rows // k
    blocks, gpb = ntt_small.launch_geometry(polys, k, n, sms)
    stride = blocks * gpb
    take = {}
    for tower in range(k):
        for b in range(blocks):
            for g in range(gpb):
                take[tower, b, g] = [p * k + tower for p in
                                     range(b * gpb + g, polys, stride)]
    return take, blocks, gpb


def model(x, tb, sms, inverse):
    """The kernel on x [rows, k, N] (uint32) over basis tb: each row
    transformed by the group `grid_rows` gives it, in the buffer of its
    turn, every row once."""
    rows, k, n = x.shape[0] * x.shape[1], x.shape[1], x.shape[2]
    log_n = n.bit_length() - 1
    take, blocks, gpb = grid_rows(rows, k, n, sms)
    assert gpb * (n >> LOG_R) <= ntt_small.BLOCK_THREADS
    blk = Block(log_n, gpb)
    flat = x.reshape(rows, n).astype(np.int64)
    u64 = lambda t: to_u32(t).astype(np.int64)
    psi = u64(tb.ipsi_br if inverse else tb.psi_br)
    out = np.full_like(flat, -1)
    for tower in range(k):
        s_tw = blk.staged_twiddles(psi[tower:tower + 1], gpb * blk.t)
        q = np.int64(tb.moduli[tower])
        for turn in range(max(len(r) for r in take.values())):
            got = [r[turn] for (t, _, _), r in take.items()
                   if t == tower and turn < len(r)]
            assert all(r % k == tower for r in got)
            assert (out[got] == -1).all()             # each row once
            if inverse:
                ninv = np.int64(u64(tb.ninv).reshape(-1)[tower])
                out[got] = model_inv(flat[got], s_tw, q, ninv, blk, turn & 1)
            else:
                out[got] = model_fwd(flat[got], s_tw, q, blk, turn & 1)
    assert (out >= 0).all()
    return out.reshape(x.shape).astype(np.uint32)


# ---------------------------------------------------------------------------
# the plain versions and the model against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(128, 1), (1024, 1), (256, 3), (2048, 2)])
def test_dense_plain_matches_jax(n, k):
    moduli = _moduli(n, k)
    jb, tb = jmake_basis(moduli, n), make_basis(moduli, n)
    x = _rand(np.random.default_rng(n + k), moduli, n, 3)
    fwd = to_u32(ntt_small._ntt_small_fwd_ref(u32_tensor(x), tb))
    np.testing.assert_array_equal(
        fwd, np.asarray(jntt_small.ntt_fwd_mat(x, jb, force_ref=True)))
    np.testing.assert_array_equal(fwd, np.asarray(_ntt_fwd_vpu(x, jb)))
    inv = to_u32(ntt_small._ntt_small_inv_ref(u32_tensor(fwd), tb))
    np.testing.assert_array_equal(
        inv, np.asarray(jntt_small.ntt_inv_mat(fwd, jb, force_ref=True)))
    np.testing.assert_array_equal(inv, np.asarray(_ntt_inv_vpu(fwd, jb)))
    np.testing.assert_array_equal(inv, x)               # round trip
    # the CPU wrappers are the plain versions; ops/ntt's stage loop agrees
    np.testing.assert_array_equal(
        to_u32(ntt_small.ntt_small_fwd(u32_tensor(x), tb)), fwd)
    np.testing.assert_array_equal(
        to_u32(ntt.ntt_inv(u32_tensor(fwd), tb)), x)
    # the kernel's schedule at the card's geometry
    np.testing.assert_array_equal(model(x, tb, H100_SMS, False), fwd)
    np.testing.assert_array_equal(model(fwd, tb, H100_SMS, True), x)


def test_dense_plain_batched_31_bit():
    """Leading batch axes and 31-bit moduli (limb sums near 2^50)."""
    n = 256
    moduli = _moduli(n, 2, bits=31)
    tb = make_basis(moduli, n)
    rng = np.random.default_rng(4)
    x = rng.integers(0, min(moduli), (2, 3, 2, n)).astype(np.uint32)
    x[..., 0] = min(moduli) - 1
    fwd = ntt_small._ntt_small_fwd_ref(u32_tensor(x), tb)
    assert fwd.shape == x.shape and fwd.dtype == torch.int32
    np.testing.assert_array_equal(
        to_u32(fwd), to_u32(ntt._ntt_fwd_ref(u32_tensor(x), tb)))
    np.testing.assert_array_equal(
        to_u32(ntt_small._ntt_small_inv_ref(fwd, tb)), x)


# (N, towers' bits, rows, SMs): 31-bit towers at every k, N = 512, and a
# card of few SMs, so that groups take several rows in turn (both
# buffers) and blocks hold fewer groups than they could
SCHEDULE_CASES = [(512, (27, 27, 31, 31), 12, 1),
                  (128, (31,), 3, H100_SMS),
                  (256, (31, 31, 27), 9, 1),
                  (1024, (31, 27), 10, 1)]


@pytest.mark.parametrize("n,bits,rows,sms", SCHEDULE_CASES,
                         ids=[f"N{c[0]}-k{len(c[1])}-sms{c[3]}"
                              for c in SCHEDULE_CASES])
def test_schedule_model_matches_jax(n, bits, rows, sms):
    moduli = []
    for b in bits:
        q = first_prime(b, 2 * n)
        while q in moduli:
            q = next_prime(q, 2 * n)
        moduli.append(q)
    k = len(moduli)
    jb, tb = jmake_basis(moduli, n), make_basis(moduli, n)
    x = _rand(np.random.default_rng(n * k + rows), moduli, n, rows // k)
    fwd = model(x, tb, sms, False)
    np.testing.assert_array_equal(
        fwd, np.asarray(jntt_small.ntt_fwd_mat(x, jb, force_ref=True)))
    np.testing.assert_array_equal(
        fwd, to_u32(ntt_small._ntt_small_fwd_ref(u32_tensor(x), tb)))
    inv = model(fwd, tb, sms, True)
    np.testing.assert_array_equal(
        inv, np.asarray(jntt_small.ntt_inv_mat(fwd, jb, force_ref=True)))
    np.testing.assert_array_equal(
        inv, to_u32(ntt_small._ntt_small_inv_ref(u32_tensor(fwd), tb)))
    np.testing.assert_array_equal(inv, x)


# ---------------------------------------------------------------------------
# geometry and the wrappers
# ---------------------------------------------------------------------------

def test_grid_takes_every_row_once_in_its_tower():
    """Every row of every launch is taken once, by a group of a block of
    its own tower; the groups' shares differ by one row at most; a block
    holds at most BLOCK_THREADS threads; one ring element is one block of
    one group, and the gate batch's digits fill the card in one wave, each
    group taking two rows in turn."""
    for n in (128, 256, 512, 1024, 2048):
        for k in (1, 2, 3, 4):
            for polys in (1, 2, 7, 64, 513, 1536):
                for sms in (1, 3, H100_SMS):
                    take, blocks, gpb = grid_rows(polys * k, k, n, sms)
                    got = sorted(r for rs in take.values() for r in rs)
                    assert got == list(range(polys * k))
                    counts = [len(rs) for rs in take.values() if rs]
                    assert max(counts) - min(counts) <= 1
                    assert 1 <= gpb * (n >> LOG_R) <= ntt_small.BLOCK_THREADS
                    assert (blocks - 1) * gpb < polys   # no idle block
    assert ntt_small.launch_geometry(1, 1, 1024, H100_SMS) == (1, 1)
    blocks, gpb = ntt_small.launch_geometry(1536, 1, 1024, H100_SMS)
    assert blocks * gpb * 2 == 1536
    assert blocks <= ntt_small.BLOCKS_PER_SM * H100_SMS


def test_geometry_constants_match_the_kernel_source():
    """ops/ntt_small.py's geometry and this model's swizzle are the
    constants the kernel is compiled with."""
    csrc = Path(ntt_small.__file__).resolve().parents[1] / "csrc"
    const = {}
    for name in ("ntt_small.cu", "ntt_cluster.cuh"):
        const.update({k: int(v) for k, v in re.findall(
            r"constexpr int (k\w+) = (\d+);", (csrc / name).read_text())})
    assert 1 << const["kMinLog"] == ntt_small.MIN_RING_DIM
    assert 1 << const["kMaxLog"] == ntt_small.MAX_RING_DIM
    assert const["kMaxTowers"] == ntt_small.MAX_TOWERS
    assert const["kBlockThreads"] == ntt_small.BLOCK_THREADS
    assert const["kBlocksPerSm"] == ntt_small.BLOCKS_PER_SM
    assert const["kLogR"] == ntt_small.LOG_THREAD_WORDS == LOG_R
    assert const["kSwizzleLog"] == SWIZZLE_LOG


def test_wrappers_refuse_what_the_kernel_does_not_take():
    """Off the CPU a wrapper launches its kernel or raises: a device
    without a kernel, rings outside 128..2048, more than 4 towers, other
    dtypes and non-contiguous tensors are refused."""
    meta = lambda *shape, dtype=torch.int32: torch.empty(
        shape, dtype=dtype, device="meta")
    tb = make_basis(_moduli(1024, 1), 1024)
    for fn in (ntt_small.ntt_small_fwd, ntt_small.ntt_small_inv):
        name = fn.__name__
        with pytest.raises(ValueError, match=f"{name}: no kernel"):
            fn(meta(4, 1, 1024), tb)
        with pytest.raises(TypeError, match="int32"):
            fn(meta(4, 1, 1024, dtype=torch.int64), tb)
        with pytest.raises(ValueError, match="contiguous"):
            fn(meta(1024, 1, 4).transpose(0, 2), tb)
        with pytest.raises(ValueError, match="does not match"):
            fn(meta(4, 2, 1024), tb)
        for n, k in ((64, 1), (4096, 1), (256, 5)):
            b = make_basis(_moduli(n, k), n)
            with pytest.raises(ValueError, match="takes 128 <= N <= 2048"):
                fn(meta(2, k, n), b)
    # ops/ntt sends a small ring of a CUDA-like device to these wrappers
    with pytest.raises(ValueError, match="ntt_small_fwd: no kernel"):
        ntt.ntt_fwd(meta(2, 1, 1024), tb)
    assert not ntt_small.supported(make_basis(_moduli(1 << 13, 1), 1 << 13))
