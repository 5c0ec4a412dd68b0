"""The port's composite-Q blind rotation
(`openfhe_tpu_torch/binfhe/blind_rotate.py` `blind_rotate_cggi_wide`)
against the JAX package's `rgsw_wide.eval_acc_cggi_wide`.

Any words are valid inputs to a blind rotation, so the keys and the
accumulators are seeded numpy words below each tower and no keygen runs.
JAX's scan and the port's wrapper on the CPU (its plain twin, the per-step
loop over the table `idx` that the kernel reads on the card) must return
the same words, tolerance 0, at the small wide ring of
`test_torch_binfhe_wide.py` and at STD192's shape (N = 2048, d2 = 4) over
2 steps. The kernel runs only on the card, where `chip_smoke.py` holds it
against the per-step loop; here the wrapper must refuse what it does not
take and never launch for a CPU tensor, and a numpy model of the kernel's
Garner lift and digits (`csrc/blind_rotate.cu` `decompose_wide`) must equal
`rgsw_wide.signed_digits` at the edges of Q.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openfhe_tpu.binfhe import rgsw_wide as jrw  # noqa: E402
from openfhe_tpu_torch import _build  # noqa: E402
from openfhe_tpu_torch.binfhe import blind_rotate as br  # noqa: E402
from openfhe_tpu_torch.binfhe import rgsw_wide  # noqa: E402
from openfhe_tpu_torch.binfhe.constants import PARAM_SETS  # noqa: E402
from openfhe_tpu_torch.lattice.basis import make_basis  # noqa: E402
from openfhe_tpu_torch.math import nbtheory  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32, u32_tensor  # noqa: E402
from test_torch_scale_conv_cluster import _c_signature  # noqa: E402

# (n, N, q_bits, q, base_g): the small wide ring of
# test_torch_binfhe_wide.py (Q of 35 bits, d2 = 6), STD192 cut to 2 steps
SMALL = (16, 512, 34, 1024, 1 << 9)
STD192 = (2, 2048, 37, 2048, 1 << 13)
SPLIT = 5


def _params(shape):
    return (jrw.make_rgsw_wide_params(*shape),
            rgsw_wide.make_rgsw_wide_params(*shape, device="cpu"))


def _inputs(params, batch: int, seed: int):
    """(key, acc0, acc1, a) as numpy words: every tower's words below its
    modulus, a below q."""
    rng = np.random.default_rng(seed)
    n, big_n, d2 = params.n_lwe, params.ring_dim, params.digits_g2
    words = lambda *lead: np.stack(
        [rng.integers(0, m, size=lead + (big_n,)) for m in params.moduli],
        axis=-2)
    return (words(n, 2, d2, 2), words(batch), words(batch),
            rng.integers(0, params.q_lwe, size=(batch, n)))


@pytest.fixture
def no_launch(monkeypatch):
    """Fail on any kernel launch."""
    def launch(*args):
        raise AssertionError(f"launched {args[1]}")
    monkeypatch.setattr(_build, "launch", launch)


@pytest.mark.parametrize("shape,batch", [(SMALL, 3), (STD192, 2)],
                         ids=["small_ring", "std192_two_steps"])
def test_wrapper_words_equal_jax(shape, batch, no_launch):
    """The wrapper on the CPU, the dispatch of `eval_acc_cggi_wide` and the
    per-step loop all return JAX's words."""
    jparams, params = _params(shape)
    key, acc0, acc1, a = _inputs(params, batch, seed=batch)
    j = lambda x: jnp.asarray(x.astype(np.uint32))
    want = jrw.eval_acc_cggi_wide(jparams, j(key), j(acc0), j(acc1), j(a))
    tkey, t0, t1, ta = (u32_tensor(x) for x in (key, acc0, acc1, a))
    got = br.blind_rotate_cggi_wide(params, tkey, br.cggi_idx(params, ta),
                                    t0, t1)
    via = rgsw_wide.eval_acc_cggi_wide(params, tkey, t0, t1, ta)
    loop = rgsw_wide._eval_acc_cggi_wide_steps(params, tkey, t0, t1, ta)
    for w, *mine in zip(want, got, via, loop):
        for m in mine:
            assert m.dtype == torch.int32 and m.shape == (batch, 2,
                                                          params.ring_dim)
            np.testing.assert_array_equal(to_u32(m), np.asarray(w))


def test_split_run_equals_whole(no_launch):
    """Steps [0, SPLIT) then [SPLIT, n) give the words of [0, n)."""
    _, params = _params(SMALL)
    key, acc0, acc1, a = (u32_tensor(x) for x in _inputs(params, 2, 1))
    idx = br.cggi_idx(params, a)
    whole = br.blind_rotate_cggi_wide(params, key, idx, acc0, acc1)
    part = br.blind_rotate_cggi_wide(params, key, idx, acc0, acc1, 0, SPLIT)
    part = br.blind_rotate_cggi_wide(params, key, idx, *part, lo=SPLIT)
    for w, p in zip(whole, part):
        assert torch.equal(w, p)
    assert not torch.equal(whole[0], acc0)


def test_smem_fits_a_cluster_block_for_every_wide_ginx_set():
    """Every GINX set with more than 31 bits of Q is taken: one tower's
    block of a gate's cluster within 227 KB (96 KB at STD192)."""
    names = sorted(k for k, p in PARAM_SETS.items()
                   if p.number_bits > 31 and "LMKCDEY" not in k)
    assert len(names) >= 6
    for name in names:
        p = PARAM_SETS[name]
        params = rgsw_wide.make_rgsw_wide_params(
            p.lattice_param, p.cyc_order // 2, p.number_bits, p.mod,
            p.base_g)
        smem = br.smem_bytes(params.ring_dim, params.digits_g2, br.WIDE_FORM)
        assert smem <= br.MAX_SMEM_BYTES, name
        assert br.supported(params, br.WIDE_FORM), name
    std192 = rgsw_wide.make_rgsw_wide_params(*STD192)
    assert br.smem_bytes(2048, std192.digits_g2, br.WIDE_FORM) == 96 * 1024


def _refused(case: str):
    """(params, match) of a ring the kernel does not take."""
    _, params = _params(SMALL)
    n = params.ring_dim
    q1, q2 = params.moduli
    if case == "one_tower":
        return params.replace(basis=make_basis([q1], n)), "two towers, not 1"
    if case == "three_towers":
        q3 = nbtheory.previous_prime(q2, 2 * n)
        return (params.replace(basis=make_basis([q1, q2, q3], n)),
                "two towers, not 3")
    if case == "ring_4096":
        return (rgsw_wide.make_rgsw_wide_params(2, 4096, 34, 1024, 1 << 9),
                "N=4096")
    if case == "base_not_power_of_2":
        return params.replace(base_g=3 << 7), "not a power of 2"
    if case == "tower_2_29":
        big = rgsw_wide.make_rgsw_wide_params(2, 512, 58, 1024, 1 << 20)
        assert max(big.moduli) >= 1 << 29
        return big, "towers below 2\\^29"
    return params.replace(digits_g=10), "at most 16 gadget rows, not 18"


@pytest.mark.parametrize("case", ["one_tower", "three_towers", "ring_4096",
                                  "base_not_power_of_2", "tower_2_29",
                                  "d2_18"])
def test_wrapper_refuses_rings_the_kernel_does_not_take(case, no_launch):
    """On every device, CPU tensors included; the per-step loop's entry
    refuses them too, and nothing launches."""
    params, match = _refused(case)
    n, d2 = params.ring_dim, params.digits_g2
    key = torch.zeros((2, 2, d2, 2, 2, n), dtype=torch.int32)
    acc = torch.zeros((1, 2, n), dtype=torch.int32)
    idx = torch.zeros((2, 1), dtype=torch.int32)
    assert not br.supported(params, br.WIDE_FORM)
    with pytest.raises(ValueError, match=match):
        br.blind_rotate_cggi_wide(params, key, idx, acc, acc)
    with pytest.raises(ValueError, match=match):
        rgsw_wide._eval_acc_cggi_wide_steps(params, key, acc, acc,
                                            idx.t().contiguous())


def test_wrapper_refuses_operands_off_the_cpu(no_launch):
    """Off the CPU the wrapper launches its kernel or raises: other dtypes,
    shapes, non-contiguous tensors, step ranges, a basis on another device
    and a device without a kernel (meta) are refused."""
    _, params = _params(SMALL)
    n, d2, steps, batch = params.ring_dim, params.digits_g2, 4, 3
    meta = lambda *shape: torch.empty(shape, dtype=torch.int32,
                                      device="meta")
    key, idx = meta(steps, 2, d2, 2, 2, n), meta(steps, batch)
    acc0, acc1 = meta(batch, 2, n), meta(batch, 2, n)
    mp = params.replace(basis=params.basis.to("meta"),
                        psi_pow=params.psi_pow.to("meta"),
                        eval_exp=params.eval_exp.to("meta"),
                        q_col=params.q_col.to("meta"))
    rotate = br.blind_rotate_cggi_wide
    with pytest.raises(ValueError, match="cggi_wide: no kernel for device"):
        rotate(mp, key, idx, acc0, acc1)
    with pytest.raises(ValueError, match="basis on cpu"):
        rotate(params, key, idx, acc0, acc1)
    with pytest.raises(TypeError, match="acc0 must be int32"):
        rotate(mp, key, idx, acc0.long(), acc1)
    with pytest.raises(TypeError, match="bskey must be int32"):
        rotate(mp, key.long(), idx, acc0, acc1)
    with pytest.raises(ValueError, match="bskey has shape"):
        rotate(mp, key[:, :, :, :, :1], idx, acc0, acc1)
    with pytest.raises(ValueError, match="acc0 has shape"):
        rotate(mp, key, idx, meta(batch, n), meta(batch, n))
    with pytest.raises(ValueError, match="idx has shape"):
        rotate(mp, key, meta(steps, batch + 1), acc0, acc1)
    with pytest.raises(ValueError, match="contiguous"):
        rotate(mp, key, idx, meta(2, batch, n).transpose(0, 1), acc1)
    with pytest.raises(ValueError, match=r"steps \[3, 2\)"):
        rotate(mp, key, idx, acc0, acc1, lo=3, hi=2)
    with pytest.raises(ValueError, match=r"steps \[0, 5\)"):
        rotate(mp, key, idx, acc0, acc1, hi=5)


def test_entry_registered_with_its_c_signature():
    """`_build.SOURCES` holds the entry with the argtypes of its C
    signature: 14 pointers, q1^-1 and 7 ints, the stream."""
    fn = "blind_rotate_cggi_wide"
    p, i = _build._P, _build._I
    assert _build.SOURCES["blind_rotate"][fn] == _c_signature(
        "blind_rotate", fn) == [p] * 14 + [i] * 8 + [p]


def _model_digits(params, x1, x2):
    """`decompose_wide` of csrc/blind_rotate.cu in numpy, line for line:
    the digits after the first of the coefficients with residues (x1, x2)
    (uint64 arrays), as int64 rows, and their residues in each tower."""
    q1, q2 = params.moduli
    q1_inv = pow(q1, -1, q2)
    big_q = np.uint64(q1 * q2)
    g = params.base_g.bit_length() - 1
    sh = np.uint64(64 - g)
    x1m = x1 % np.uint64(q2)
    diff = np.where(x2 >= x1m, x2 - x1m, x2 + (np.uint64(q2) - x1m))
    t = diff * np.uint64(q1_inv) % np.uint64(q2)
    x = x1 + np.uint64(q1) * t
    c = x.astype(np.int64) - np.where(x >= big_q >> np.uint64(1),
                                      np.int64(big_q), np.int64(0))

    def low_digit(c):
        r = (c.astype(np.uint64) << sh).astype(np.int64) >> sh.astype(
            np.int64)
        return r, (c - r) >> np.int64(g)

    _, c = low_digit(c)
    digits = []
    for _ in range(params.digits_g - 1):
        r, c = low_digit(c)
        digits.append(r)
    res = [[np.where(v < 0, v + q, v).astype(np.uint32) for v in digits]
           for q in (q1, q2)]
    return digits, res


def test_kernel_digit_arithmetic_equals_signed_digits():
    """At the small ring, STD192 and STD128Q_4 (50 bits, 8 digits): Garner
    in unsigned 64-bit words and the digits in int64, against
    `rgsw_wide.garner` / `signed_digits` / `digits_to_residues`, at 0, 1,
    Q - 1, Q/2 and its neighbours, digit boundaries and random values."""
    q4 = PARAM_SETS["STD128Q_4"]
    for shape in (SMALL, STD192, (2, q4.cyc_order // 2, q4.number_bits,
                                  q4.mod, q4.base_g)):
        params = rgsw_wide.make_rgsw_wide_params(*shape)
        big_q, base = params.big_q, params.base_g
        rng = np.random.default_rng(shape[2])
        x = rng.integers(0, big_q, size=256, dtype=np.int64)
        edge = [0, 1, 2, big_q - 1, big_q - 2, big_q // 2 - 1, big_q // 2,
                big_q // 2 + 1, big_q // 2 + 2, base // 2 - 1, base // 2,
                base - 1, big_q - base // 2, big_q - base // 2 - 1]
        edge += [(base // 2) * base ** k for k in (1, 2, 3)]
        x[:len(edge)] = [v % big_q for v in edge]
        x1, x2 = (x % m for m in params.moduli)
        digits, res = _model_digits(params, x1.astype(np.uint64),
                                    x2.astype(np.uint64))
        lifted = rgsw_wide.garner(params, torch.from_numpy(
            np.stack([x1, x2])[None]))[0]
        np.testing.assert_array_equal(lifted.numpy(), x)
        want = rgsw_wide.signed_digits(params, lifted)
        assert len(want) == len(digits) == params.digits_g2 // 2
        for m, w in zip(digits, want):
            np.testing.assert_array_equal(m, w.numpy())
        towers = to_u32(rgsw_wide.digits_to_residues(params, want))
        for t in range(2):                        # towers [ndig, 2, N]
            np.testing.assert_array_equal(np.stack(res[t]), towers[:, t])
