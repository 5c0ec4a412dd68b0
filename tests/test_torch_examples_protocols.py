"""The port's threshold, PRE and interactive-bootstrapping examples
(`examples_torch/`) on the CPU, each at its JAX counterpart's own
parameters: BGV / BFV results exactly, CKKS within the JAX example's
asserted tolerance or 1e-3 (`test_torch_examples_leveled.check_example`).
The interactive bootstraps also hand back more towers than they took."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_examples_leveled import (check_example,  # noqa: E402
                                         one_thread)  # noqa: F401


@pytest.mark.parametrize("name, tols", [
    ("threshold_fhe", {"2x": 1e-3}),
    ("threshold_fhe_5p", {"x+y": None}),
    ("pre_buffer", {"alice": None, "bob": None}),
    ("pre_hra_secure", {"FIXED_NOISE_HRA": None, "NOISE_FLOODING_HRA": None}),
    ("interactive_bootstrapping", {"refreshed": 1e-3}),
    ("tckks_interactive_mp_bootstrapping", {"refreshed": 1e-2,
                                            "logistic": 5e-2}),
    ("tckks_interactive_mp_bootstrapping_chebyshev", {"chebyshev": 5e-2}),
])
def test_protocol_example(name, tols):
    out = check_example(name, tols)
    if "towers" in out:
        before, after = out["towers"]
        assert after > before
    if name == "pre_buffer":
        assert len(out["checks"]["bob"][0]) == 1 << 12
