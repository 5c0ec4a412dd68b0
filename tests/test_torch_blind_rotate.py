"""The port's blind rotation (`openfhe_tpu_torch/binfhe/blind_rotate.py`)
against the JAX package's three scans.

Any words are valid inputs to a blind rotation, so the keys and the
accumulators are seeded numpy words below Q and no keygen runs. JAX's
`eval_acc_cggi`, `eval_acc_dm` and `eval_acc_lmkcdey_scan` and the port's
wrappers on the CPU (their plain twins, over the per-step tables that the
kernel reads on the card) must return the same words, tolerance 0. The
kernel itself runs only on the card, where `chip_smoke.py` holds it
against the per-step loop; here the wrappers must refuse what it does not
take, and never fall back to the loop off the CPU.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from openfhe_tpu.binfhe import rgsw as jrgsw  # noqa: E402
from openfhe_tpu_torch.binfhe import blind_rotate as br  # noqa: E402
from openfhe_tpu_torch.binfhe import rgsw  # noqa: E402
from openfhe_tpu_torch.binfhe.constants import BINFHE_METHOD  # noqa: E402
from openfhe_tpu_torch.binfhe.context import BinFHEContext  # noqa: E402
from openfhe_tpu_torch.lattice.basis import make_basis  # noqa: E402
from openfhe_tpu_torch.math import nbtheory  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32, u32_tensor  # noqa: E402

FORMS = br.FORMS
# per form (n, N, q, base_g): d2 = 6 at base 2^7, 4 at base 2^9 (Q 27 bits)
SHAPES = {"cggi": (12, 256, 512, 128), "dm": (6, 256, 512, 512),
          "lmkcdey": (10, 256, 128, 512)}
BATCH = 3
BASE_R = 8          # AP: 3 digits of q = 512
AUTO_KEYS = 6       # LMKCDEY window
SPLIT = 5           # steps of the first part of a split run


def _params(form: str):
    n, big_n, q, base_g = SHAPES[form]
    big_q = nbtheory.previous_prime(1 << 27, 2 * big_n)
    return (jrgsw.make_rgsw_params(n, big_n, big_q, q, base_g),
            rgsw.make_rgsw_params(n, big_n, big_q, q, base_g, device="cpu"))


def _inputs(form: str, params, seed: int = 0):
    """(keys, tables, acc0, acc1, a) as numpy words, and the wrapper's
    (keys, tables) as tensors."""
    rng = np.random.default_rng(seed)
    n, big_n, q = params.n_lwe, params.ring_dim, params.q_lwe
    d2, big_q = params.digits_g2, params.big_q
    words = lambda *shape: rng.integers(0, big_q, size=shape, dtype=np.int64)
    acc0, acc1 = words(BATCH, big_n), words(BATCH, big_n)
    a = rng.integers(0, q, size=(BATCH, n), dtype=np.int64)
    a_t = u32_tensor(a)
    if form == "cggi":
        keys = words(n, 2, d2, 2, big_n)
        return (keys, None, acc0, acc1, a), (u32_tensor(keys),
                                            br.cggi_idx(params, a_t))
    if form == "dm":
        digits_r = math.ceil(math.log(q) / math.log(BASE_R))
        keys = words(n, digits_r, BASE_R, d2, 2, big_n)
        return (keys, digits_r, acc0, acc1, a), (
            u32_tensor(keys.reshape(-1, d2, 2, big_n)),
            br.dm_rows(params, digits_r, BASE_R, a_t))
    bank = words(1 + n + AUTO_KEYS + 1, d2, 2, big_n)
    perm = rgsw.lmkcdey_perm_table(params, AUTO_KEYS)
    sched = br.lmkcdey_sched(params, a_t, AUTO_KEYS)
    return (bank, (perm, sched.numpy()), acc0, acc1, a), (
        u32_tensor(bank), (torch.from_numpy(perm), sched))


WRAPPERS = {"cggi": br.blind_rotate_cggi, "dm": br.blind_rotate_dm,
            "lmkcdey": br.blind_rotate_lmkcdey}


@pytest.mark.parametrize("form", FORMS)
def test_wrapper_words_equal_jax(form):
    """The wrapper on the CPU and the dispatch of `rgsw.eval_acc_*` both
    return JAX's words."""
    jparams, params = _params(form)
    (keys, extra, acc0, acc1, a), (tkeys, tables) = _inputs(form, params)
    j = lambda x: jnp.asarray(np.asarray(x).astype(np.uint32))
    if form == "cggi":
        want = jrgsw.eval_acc_cggi(jparams, j(keys), j(acc0), j(acc1), j(a))
        via = rgsw.eval_acc_cggi(params, tkeys, u32_tensor(acc0),
                                 u32_tensor(acc1), u32_tensor(a))
    elif form == "dm":
        want = jrgsw.eval_acc_dm(jparams, j(keys), extra, BASE_R, j(acc0),
                                 j(acc1), j(a))
        via = rgsw.eval_acc_dm(params, u32_tensor(keys), extra, BASE_R,
                               u32_tensor(acc0), u32_tensor(acc1),
                               u32_tensor(a))
    else:
        perm, sched = extra
        want = jrgsw.eval_acc_lmkcdey_scan(jparams, j(keys), jnp.asarray(perm),
                                           jnp.asarray(sched), j(acc0),
                                           j(acc1))
        via = rgsw.eval_acc_lmkcdey_scan(params, tkeys, tables[0], tables[1],
                                         u32_tensor(acc0), u32_tensor(acc1))
    got = WRAPPERS[form](params, tkeys, tables, u32_tensor(acc0),
                         u32_tensor(acc1))
    for g, v, w in zip(got, via, want):
        np.testing.assert_array_equal(to_u32(g), np.asarray(w))
        np.testing.assert_array_equal(to_u32(v), np.asarray(w))


@pytest.mark.parametrize("form", FORMS)
def test_split_run_equals_whole(form):
    """Steps [0, k) then [k, steps) give the words of [0, steps)."""
    _, params = _params(form)
    (_, _, acc0, acc1, _), (tkeys, tables) = _inputs(form, params, seed=1)
    rotate = WRAPPERS[form]
    acc = (u32_tensor(acc0), u32_tensor(acc1))
    whole = rotate(params, tkeys, tables, *acc)
    part = rotate(params, tkeys, tables, *acc, lo=0, hi=SPLIT)
    part = rotate(params, tkeys, tables, *part, lo=SPLIT)
    for w, p in zip(whole, part):
        assert torch.equal(w, p)
    assert not torch.equal(whole[0], acc[0])


def test_smem_within_a_block_at_std128_and_refused_above():
    for name, method, form in (("STD128", BINFHE_METHOD.GINX, "cggi"),
                               ("STD128_AP", BINFHE_METHOD.AP, "dm"),
                               ("STD128_LMKCDEY", BINFHE_METHOD.LMKCDEY,
                                "lmkcdey")):
        cc = BinFHEContext(device="cpu").GenerateBinFHEContext(name, method)
        p = cc.rgsw
        assert br.smem_bytes(p.ring_dim, p.digits_g2, form) \
            <= br.MAX_SMEM_BYTES
        assert br.supported(p, form)
    assert br.smem_bytes(1024, 6, "cggi") == 56 * 1024
    # base 2 at N = 2048: 52 digit rows, 496 KB
    big_q = nbtheory.previous_prime(1 << 27, 4096)
    wide = rgsw.make_rgsw_params(8, 2048, big_q, 1024, 2, device="cpu")
    assert not br.supported(wide, "cggi")
    meta = lambda *shape: torch.empty(shape, dtype=torch.int32,
                                      device="meta")
    with pytest.raises(ValueError, match="shared memory"):
        br.blind_rotate_cggi(wide, meta(8, 2, wide.digits_g2, 2, 2048),
                             meta(8, 2), meta(2, 2048), meta(2, 2048))


def _meta_operands(form: str, params):
    """Well-formed operands on the meta device: (keys, tables, acc0,
    acc1)."""
    n, d2, big_n = params.n_lwe, params.digits_g2, params.ring_dim
    meta = lambda *shape: torch.empty(shape, dtype=torch.int32,
                                      device="meta")
    acc = (meta(BATCH, big_n), meta(BATCH, big_n))
    if form == "cggi":
        return (meta(n, 2, d2, 2, big_n), meta(n, BATCH)) + acc
    if form == "dm":
        return (meta(9 * n, d2, 2, big_n), meta(3 * n, BATCH)) + acc
    return (meta(n + 8, d2, 2, big_n),
            (meta(AUTO_KEYS + 2, big_n), meta(40, BATCH, 5))) + acc


@pytest.mark.parametrize("form", FORMS)
def test_wrappers_refuse_what_the_kernel_does_not_take(form):
    """Off the CPU a wrapper launches its kernel or raises: other dtypes,
    shapes, tower counts, non-contiguous tensors, step ranges, a basis on
    another device and a device without a kernel (meta) are refused."""
    _, params = _params(form)
    rotate = WRAPPERS[form]
    keys, tables, acc0, acc1 = _meta_operands(form, params)
    meta_params = params.replace(basis=params.basis.to("meta"),
                                 psi_pow=params.psi_pow.to("meta"),
                                 eval_exp=params.eval_exp.to("meta"))
    name = f"blind_rotate_{form}"
    with pytest.raises(ValueError, match=f"{name}: no kernel for device"):
        rotate(meta_params, keys, tables, acc0, acc1)
    with pytest.raises(ValueError, match="basis on cpu"):
        rotate(params, keys, tables, acc0, acc1)
    with pytest.raises(TypeError, match="int32"):
        rotate(meta_params, keys, tables, acc0.long(), acc1)
    with pytest.raises(TypeError, match="int32"):
        rotate(meta_params, keys.long(), tables, acc0, acc1)
    with pytest.raises(ValueError, match="shape"):
        rotate(meta_params, keys[:, :1], tables, acc0, acc1)
    with pytest.raises(ValueError, match="shape"):
        rotate(meta_params, keys, tables, acc0[:2], acc1[:2])
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.empty((params.ring_dim, BATCH), dtype=torch.int32,
                           device="meta")
        rotate(meta_params, keys, tables, wide.t(), acc1)
    with pytest.raises(ValueError, match=r"steps \[3, 2\)"):
        rotate(meta_params, keys, tables, acc0, acc1, lo=3, hi=2)
    two = make_basis([params.big_q, nbtheory.previous_prime(
        params.big_q, 2 * params.ring_dim)], params.ring_dim)
    with pytest.raises(ValueError, match="one tower"):
        rotate(params.replace(basis=two), keys, tables, acc0, acc1)
