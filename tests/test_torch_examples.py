"""The port's examples (`examples_torch/`) on the CPU, each result checked.

`simple_integers.py` (BFV) and `pre.py` (BGV PRE) exactly,
`simple_real_numbers.py` (CKKS at 28-bit scales, N = 2^12) within 1e-3
of the plain computation, `sampling.py` at 8 centers (the example's 64
build 128 base samplers, seconds of host Python) by the samplers'
statistics, and `external_prng.py` with both engines, its counting
engine's words and its card-side draws checked.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from examples_torch import (external_prng, pre, sampling,  # noqa: E402
                            simple_integers, simple_real_numbers)
from openfhe_tpu_torch.utils import prng  # noqa: E402


def test_simple_integers():
    out = simple_integers.main(device="cpu")
    np.testing.assert_array_equal(out["add"], out["want_add"])
    np.testing.assert_array_equal(out["mul"], out["want_mul"])


def test_simple_real_numbers():
    out = simple_real_numbers.main(device="cpu")
    assert len(out) == 6
    for name, (got, want) in out.items():
        assert np.abs(got - want).max() < 1e-3, name


def test_pre():
    out = pre.main(device="cpu")
    np.testing.assert_array_equal(out["got"], out["want"])


def test_sampling():
    """Each method: 8 centers x 400 samples at sigma 2^22, mean within 5
    standard errors of the centers' (all below 1) and standard deviation
    within 10 % of 2^22; the two generic rows differ (two samplers)."""
    out = sampling.main(device="cpu", center_count=8, count=400)
    assert set(out) == {"Rejection", "Karney", "Generic - Peikert",
                        "Generic - Knuth Yao"}
    for name, res in out.items():
        x = res["samples"].astype(float)
        assert x.shape == (8, 400), name
        assert abs(x.mean()) < 5 * sampling.STD / np.sqrt(x.size), name
        assert abs(x.std() / sampling.STD - 1) < 0.1, name
        assert res["ms_per_center"] > 0
    assert not np.array_equal(out["Generic - Peikert"]["samples"],
                              out["Generic - Knuth Yao"]["samples"])


def test_external_prng():
    builtin = external_prng.main(device="cpu")
    ext = external_prng.main(device="cpu", external=True)
    engine = external_prng.CountingEngine()
    words = [engine() for _ in range(7)]
    assert ext["draws"] == [w % 11 for w in words[:5]]
    assert ext["seed"] == (words[5] << 32) | words[6]
    for out in (builtin, ext):
        assert all(0 <= d <= 10 for d in out["draws"])
        assert out["gaussians"].shape == (8,)
        assert np.abs(out["gaussians"]).max() <= 12 * 3.19
    assert isinstance(prng.get_prng(), prng.Blake2Engine)
