"""K1/K4 (`intt_scale`) on the cluster INTT and kernel k
(`mod_matmul_rowmod`) on the lazy conversion, on the CPU.

`csrc/ks_fused.cu` runs `intt_scale` as one launch of `inv_cluster`, K45's
first launch, whose output row r reads input row (r / k) * in_rows +
in_off + r % k: K1 with (k, in_rows, in_off) = (kql, kql, 0) on c2, K4
with (kp, kql + kp, kql) on ext's P rows, read in place; the last multiply
is N^-1 times the per-tower constant (k1_scale, k45_scale). `csrc/rowmod.cu`
runs `mod_matmul_rowmod` as one launch of `pconv` (csrc/pconv_core.cuh):
`batch` batches of A rows over one table (w_stride 0, no own rows). There
is no card here, so both are run through the numpy models of
tests/test_torch_ntt_cluster.py (`model_inv`) and
tests/test_torch_ks_cluster.py (`model_pconv`) with the launches'
arguments, and held word for word (tolerance 0):

- K1 and K4 against JAX's Pallas kernels `_intt_scale_pairs` and
  `_intt_scale` (interpret mode, as tests/test_ks_fused.py runs them) at
  levels 0 and 1 of 3 Q + 2 P 27-bit primes (N = 2^12, two digits), and on
  the largest 31-bit primes (beyond the moduli JAX's Karatsuba kernels
  take) against JAX's NTT with exact products; always against the port's
  plain twin;
- kernel k at the main path's digit -> complement (16 -> 31, 15 -> 32)
  and P -> Q (16 -> 31) shapes on the largest 31-bit primes, batch 1 and
  2, against JAX's `mod_matmul_rowmod` on words below 2^30 (the JAX
  package's moduli are below 2^30, and its four int8 limbs of a word, read
  as a signed int32, cover less than 2^31) and against the port's plain
  version and exact integer sums on words up to 2^32 - 1 (the kernels read
  them unsigned).

Then the wrappers' choice of entry by shape before the launch (and
kernel k's refusals: it launches `pconv` or raises), and the entries'
registration against their C signatures.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openfhe_tpu.lattice import basis as jbasis  # noqa: E402
from openfhe_tpu.ops import modmatmul as jmm  # noqa: E402
from openfhe_tpu.ops import ntt as jntt  # noqa: E402
from openfhe_tpu.pke.keyswitch import ks_fused as jks  # noqa: E402
from openfhe_tpu_torch import _build  # noqa: E402
from openfhe_tpu_torch.lattice import rns_tools as rt  # noqa: E402
from openfhe_tpu_torch.lattice.basis import make_basis  # noqa: E402
from openfhe_tpu_torch.math import modops as mo  # noqa: E402
from openfhe_tpu_torch.math import nbtheory  # noqa: E402
from openfhe_tpu_torch.ops import modmatmul  # noqa: E402
from openfhe_tpu_torch.pke.keyswitch import ks_fused  # noqa: E402
from test_torch_ks_cluster import (_rand, _top31,  # noqa: E402
                                   model_pconv, pconv_run_refuses)
from test_torch_ntt_cluster import _kara_moduli, model_inv  # noqa: E402

N = 1 << 12
CSRC = Path(ks_fused.__file__).resolve().parents[2] / "csrc"


# ---------------------------------------------------------------------------
# K1 / K4: inv_cluster with intt_scale's (k, in_rows, in_off)
# ---------------------------------------------------------------------------

def model_intt_scale(x, tabs, p_rows, log_w):
    """intt_scale's launch of inv_cluster: x [kql, N] (K1) or [E, kql + kp,
    N] (K4) -> [kql, N] or [E, kp, N]; E * k clusters, output row r from
    input row (r / k) * in_rows + in_off + r % k of x's rows, tower r % k,
    the tower's scale (N^-1 folded in) as the last multiply."""
    kql, kp = tabs.kql, tabs.kp
    if p_rows:
        k, in_rows, in_off = kp, kql + kp, kql
        basis, scale = tabs.basis_p, tabs.k45_scale
    else:
        k, in_rows, in_off = kql, kql, 0
        basis, scale = tabs.basis_ql, tabs.k1_scale
    n = x.shape[-1]
    rows = x.reshape(-1, n)
    e = rows.shape[0] // in_rows
    r = np.arange(e * k)
    tower = r % k
    src = (r // k) * in_rows + in_off + tower
    i64 = lambda t: mo.to_u32(t).astype(np.int64)
    out = model_inv(rows[src].astype(np.int64), i64(basis.ipsi_br)[tower],
                    np.array(basis.moduli)[tower],
                    i64(scale).reshape(-1)[tower], log_w)
    return out.reshape(x.shape[:-2] + (k, n))


@pytest.fixture(scope="module")
def chain27():
    """3 Q + 2 P 27-bit primes in 2 digits: JAX's K1 and K4 (interpret
    mode) at level 0 (kql 3) and level 1 (kql 2), on seeded words."""
    mods = _kara_moduli(N, 5)
    mq, mp = mods[:3], mods[3:]
    out = {}
    jks.INTERPRET = True
    try:
        for kql in (3, 2):
            rng = np.random.default_rng(kql)
            c2, ext = _rand(rng, mq[:kql]), _rand(rng, mq[:kql] + mp, (2,))
            jt = jks.make_fused_ks_tables(mq, mp, kql, 2, N, len(mq),
                                          pad_to=None)
            r, c, kp = jt.r, jt.c, jt.kp
            k1 = jks._intt_scale_pairs(
                jnp.asarray(c2.astype(np.uint32)).reshape(kql, r, c), jt,
                jt.bhatinv_q, jt.bhatinv_q_sh)
            k4 = jks._intt_scale(
                jnp.asarray(ext.astype(np.uint32)).reshape(2, kql + kp, r, c),
                jt, kql, jt.pscale, jt.pscale_sh, k=kp, in_offset=kql)
            tabs = ks_fused.make_fused_ks_tables(
                make_basis(mq[:kql] + mp, N), kql, len(mq), 2)
            out[kql] = dict(tabs=tabs, c2=c2, ext=ext,
                            k1=np.asarray(k1).reshape(kql, N),
                            k4=np.asarray(k4).reshape(2, kp, N))
    finally:
        jks.INTERPRET = False
    return out


@pytest.mark.parametrize("chain,log_w", [("level0", 12), ("level0", 10),
                                         ("level1", 12), ("31bit", 12),
                                         ("31bit", 9)],
                         ids=["level0-C1", "level0-C4", "level1-C1",
                              "31bit-C1", "31bit-C8"])
def test_intt_scale_cluster_matches_jax_and_twin(chain27, chain, log_w):
    """Both forms of the new launch against JAX and the port's twin."""
    if chain == "31bit":
        mods = _top31(6)
        mq, mp = mods[:4], mods[4:]
        tabs = ks_fused.make_fused_ks_tables(make_basis(mods, N), 4, 4, 2)
        rng = np.random.default_rng(31)
        c2, ext = _rand(rng, mq), _rand(rng, mods, (2,))
        # JAX's stage transform, then the exact constant products
        qc = np.array(mq, np.uint64)[:, None]
        pc = np.array(mp, np.uint64)[:, None]
        inv = lambda x, m: np.asarray(jntt.ntt_inv(
            jnp.asarray(x.astype(np.uint32)),
            jbasis.make_basis(m, N))).astype(np.uint64)
        k1 = inv(c2, mq) * mo.to_u32(tabs.bhatinv_q).astype(np.uint64) % qc
        k4 = inv(ext[:, 4:], mp) * mo.to_u32(tabs.pscale).astype(
            np.uint64) % pc
        case = dict(tabs=tabs, c2=c2, ext=ext, k1=k1, k4=k4)
    else:
        case = chain27[3 if chain == "level0" else 2]
    tabs, u = case["tabs"], mo.u32_tensor
    got_k1 = model_intt_scale(case["c2"], tabs, False, log_w)
    got_k4 = model_intt_scale(case["ext"], tabs, True, log_w)
    np.testing.assert_array_equal(got_k1, case["k1"])
    np.testing.assert_array_equal(got_k4, case["k4"])
    np.testing.assert_array_equal(
        got_k1, mo.to_u32(ks_fused.intt_scale(u(case["c2"]), tabs)))
    np.testing.assert_array_equal(
        got_k4, mo.to_u32(ks_fused.intt_scale(u(case["ext"]), tabs,
                                              p_rows=True)))


# ---------------------------------------------------------------------------
# kernel k: pconv with w_stride 0 and no own rows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chain31():
    """The main path's tower counts (31 Q in digits of 16 and 15, 16 P) on
    the largest 31-bit primes."""
    mods = _top31(47, 1 << 16)
    return mods[:31], mods[31:]


def _shape(chain31, which):
    """(input moduli, output moduli) of one conversion of the main path."""
    mq, mp = chain31
    return {"digit0": (mq[:16], mq[16:] + mp),
            "digit1": (mq[16:], mq[:16] + mp),
            "p-to-q": (mp, mq)}[which]


@pytest.mark.parametrize("which", ["digit0", "digit1", "p-to-q"])
@pytest.mark.parametrize("batch,splits", [(1, 5), (2, 2)])
def test_pconv_rowmod_matches_jax_and_twin(chain31, which, batch, splits):
    """pconv as mod_matmul_rowmod launches it (a_total = batch * A, one
    table, splits as the card's 660 resident blocks give at N = 2^16)."""
    from_m, to_m = _shape(chain31, which)
    a_dim, d_dim, n = len(from_m), len(to_m), 16
    tab = rt.make_switch_tables(from_m, to_m)
    w, w_sh = mo.to_u32(tab.bhat_mod_d), mo.to_u32(tab.bhat_mod_d_sh)
    d = np.array(to_m, np.uint64)
    red = mo.to_u32(make_basis(to_m, n).red64)
    stack = lambda t: np.broadcast_to(t, (batch,) + t.shape)
    rng = np.random.default_rng(a_dim * 10 + batch)
    full = rng.integers(0, 1 << 32, (batch, a_dim, n), dtype=np.uint64)
    full[..., 0], full[..., 1] = (1 << 32) - 1, 0
    low = full & np.uint64((1 << 30) - 1)
    for x in (full, low):
        got, _ = model_pconv(x.reshape(-1, n), stack(w), stack(w_sh), d, red,
                             a_dim, batch * a_dim, splits=splits)
        twin = modmatmul._mod_matmul_rowmod_ref(
            mo.u32_tensor(x), tab.bhat_mod_d, mo.u32_tensor(d))
        np.testing.assert_array_equal(got, mo.to_u32(twin))
        exact = [(w.astype(object).T @ xb.astype(object)) % d.astype(
            object)[:, None] for xb in x]
        np.testing.assert_array_equal(got, np.array(exact, np.uint64))
    # JAX's conversion (int8 limbs of W^T, words read as int32)
    limbs = jnp.asarray(jmm.balanced_limbs_host(w.T.astype(np.int64)))
    consts = jmm.make_rowmod_consts(to_m)
    want = [np.asarray(jmm.mod_matmul_rowmod(
        limbs, jnp.asarray(xb.astype(np.uint32)), consts)) for xb in low]
    np.testing.assert_array_equal(got, np.array(want))


# ---------------------------------------------------------------------------
# the entries, their choice and their registration
# ---------------------------------------------------------------------------

def test_entries_chosen_by_shape_before_the_launch(monkeypatch):
    """intt_scale launches its cluster entry for 2^4 <= N <= 2^17 and
    intt_scale_staged otherwise, with K1's and K4's (e, k, in_rows,
    in_off); mod_matmul_rowmod launches pconv's entry (with red) at any
    shape, and raises where the entry refuses it (the launch below models
    pconv_run's checks: tables above 48 KB, N % 4 != 0, y or out off a
    16-byte boundary, more than 64 input rows), never falling back to the
    eager entry. The former forms take CUDA tensors only."""
    cpu = lambda *s: torch.zeros(s, dtype=torch.int32)
    tabs = ks_fused.make_fused_ks_tables(make_basis(_top31(3), N), 2, 2, 2)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ks_fused.intt_scale_staged(cpu(2, N), tabs)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        modmatmul.mod_matmul_rowmod_eager(cpu(2, 8), cpu(2, 3), cpu(2, 3),
                                          cpu(3, 1))
    calls = []

    def launch(src, fn, *args):
        calls.append((src, fn, args))
        if fn == "mod_matmul_rowmod":     # pconv_run's refusal, modelled
            y, out = args[0], args[5]
            batch, a_dim, d_dim, n = args[-4:]
            _build.record_launch(int(pconv_run_refuses(
                y.data_ptr(), out.data_ptr(), batch, a_dim, batch * a_dim,
                d_dim, n)), fn)
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(_build, "LAUNCHES", type(_build.LAUNCHES)())
    monkeypatch.setattr(ks_fused, "_check", lambda *a, **k: None)
    for log_n in (3, 4, 12, 16, 17, 18):
        n = 1 << log_n
        mods = [nbtheory.first_prime(bits, 2 * n) for bits in (29, 30, 31)]
        tabs = ks_fused.make_fused_ks_tables(make_basis(mods, n), 2, 2, 2)
        meta = lambda *s: torch.empty(s + (n,), dtype=torch.int32,
                                      device="meta")
        form = "intt_scale" if 4 <= log_n <= 17 else "intt_scale_staged"
        for fn, want in ((ks_fused.intt_scale, form),
                         (ks_fused.intt_scale_staged, "intt_scale_staged")):
            calls.clear()
            fn(meta(2), tabs)
            fn(meta(2, 3), tabs, p_rows=True)
            assert [(c[0], c[1]) for c in calls] == [("ks_fused", want)] * 2
            # e, k, in_rows, in_off, log2 N after the 7 pointers
            assert calls[0][2][7:] == (1, 2, 2, 0, log_n)
            assert calls[1][2][7:] == (2, 1, 3, 2, log_n)
            assert calls[1][2][2] is tabs.basis_p.ipsi_br

    def rowmod(a_dim, d_dim, n, lead=(), shift=0):
        """The entry mod_matmul_rowmod launches for CPU operands (shift
        words off y's 16-byte boundary), or the error raised when that
        entry refuses them: always the lazy entry, once."""
        batch = int(np.prod(lead, dtype=int))
        y = cpu(batch * a_dim * n + shift)[shift:].view(lead + (a_dim, n))
        w, d, red = cpu(a_dim, d_dim), cpu(d_dim, 1), cpu(d_dim, 3)
        calls.clear()
        try:
            modmatmul._mod_matmul_rowmod_cu(y, w, w, d, red,
                                            "mod_matmul_rowmod")
        except RuntimeError as err:
            found = str(err)
        else:
            found = None
        (src, fn, args), = calls
        # y, w, w_sh, d, red, out, then the ints
        assert (src, fn) == ("rowmod", "mod_matmul_rowmod")
        assert len(args) == 10
        assert all(a is b for a, b in zip(args, (y, w, w, d, red)))
        assert args[-4:] == (batch, a_dim, d_dim, n)
        return found or fn

    lazy = "mod_matmul_rowmod"
    refused = "mod_matmul_rowmod: CUDA launch failed with error 1"
    assert rowmod(16, 31, 64) == lazy          # digit -> complement
    assert rowmod(15, 32, 64, (2,)) == lazy    # a batch of 2
    assert rowmod(64, 47, 64) == lazy          # 16 D + 8 A D = 24816 bytes
    assert rowmod(16, 31, 64, shift=1) == refused   # y off 16 bytes
    assert rowmod(16, 31, 64, shift=4) == lazy
    assert rowmod(16, 31, 6) == refused        # N % 4 != 0
    assert rowmod(60, 100, 64) == refused      # 49600 bytes of tables
    assert rowmod(64, 200, 64) == refused      # 103600 bytes of tables
    assert rowmod(65, 8, 64) == refused        # more than 64 input rows


def _c_signature(source: str, fn: str) -> list:
    """The ctypes argtypes of entry `fn`'s C signature in csrc/<source>.cu:
    a pointer for each `void*` (the stream included), an int for each
    `int`."""
    text = (CSRC / f"{source}.cu").read_text()
    found = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    params = [p.split()[:-1] for p in found.group(1).split(",")]
    kinds = {"int": _build._I, "void*": _build._P}
    return [kinds[t[-1] if t[-1] == "int" else "void*"] for t in params]


@pytest.mark.parametrize("source,fn", [
    ("ks_fused", "intt_scale"), ("ks_fused", "intt_scale_staged"),
    ("rowmod", "mod_matmul_rowmod"), ("rowmod", "mod_matmul_rowmod_eager")])
def test_entries_are_registered_with_their_c_signatures(source, fn):
    """SOURCES holds each entry with the argtypes of its C signature: the
    lazy conversion takes red (Basis.red64) after d, its former form does
    not; both K1/K4 forms take the same arguments."""
    assert _build.SOURCES[source][fn] == _c_signature(source, fn)
    p, i = _build._P, _build._I
    want = {"intt_scale": [p] * 7 + [i] * 5 + [p],
            "intt_scale_staged": [p] * 7 + [i] * 5 + [p],
            "mod_matmul_rowmod": [p] * 6 + [i] * 4 + [p],
            "mod_matmul_rowmod_eager": [p] * 5 + [i] * 4 + [p]}
    assert _build.SOURCES[source][fn] == want[fn]
