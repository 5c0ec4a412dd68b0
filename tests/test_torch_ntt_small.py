"""Kernel m's plain versions (the port's `ops/ntt_small.py`) against JAX.

`_ntt_small_fwd_ref` / `_ntt_small_inv_ref` are the dense-matrix
formulation of the TPU kernel `openfhe_tpu/ops/ntt_small.py::_mat_call`;
on the card `chip_smoke.py` holds the butterfly kernel of
`csrc/ntt_small.cu` against them. Here they must equal, word for word
(tolerance 0), the JAX package's `ntt_fwd_mat` / `ntt_inv_mat` run through
their plain reference (`force_ref=True`) and its stage loop
`_ntt_fwd_vpu` / `_ntt_inv_vpu`, on inputs drawn from a seeded numpy
generator.
"""

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
