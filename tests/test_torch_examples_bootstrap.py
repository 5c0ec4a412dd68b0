"""The port's bootstrapping examples (`examples_torch/`) on the CPU, each at
its JAX counterpart's own parameters, within the JAX example's asserted
tolerance (`test_torch_examples_leveled.check_example`).

Two tolerances are not the JAX example's. `simple_ckks_bootstrapping`
asserts nothing, and at its 28-bit scales a bootstrap keeps 6-8 bits (the
JAX package's own run: a max error of 1.4e-2), so it is held to 2^-4, the
4 bits `tests/test_bootstrap.py` holds such a round trip to.
`iterative_ckks_bootstrapping`'s reference assertion (the second round
gains more than 2 bits) holds in neither package at its context (ROADMAP
queue 3), so both rounds are held to the 8 bits that hold in both. The
two-round bootstrap itself is held word for word to JAX in
`test_torch_bootstrap.py`."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_examples_leveled import (check_example,  # noqa: E402
                                         one_thread)  # noqa: F401


@pytest.mark.parametrize("name, tols", [
    ("simple_ckks_bootstrapping", {"bootstrapped": 2.0 ** -4}),
    ("simple_ckks_bootstrapping_composite_scaling", {"bootstrapped": 1e-2}),
    ("advanced_ckks_bootstrapping", {"bootstrapped": 0.1}),
    ("iterative_ckks_bootstrapping", {"one round": 2.0 ** -8,
                                      "two rounds": 2.0 ** -8}),
    ("iterative_ckks_bootstrapping_composite_scaling", {"gain": None}),
    ("functional_bootstrapping_ckks", {"f(digits)": None}),
])
def test_bootstrap_example(name, tols):
    out = check_example(name, tols)
    if name == "simple_ckks_bootstrapping":       # a depleted input
        before, after = out["towers"]
        assert after > before
    if "precision_bits" in out and name.startswith("iterative"):
        prec1, prec2 = out["precision_bits"]
        assert min(prec1, prec2) >= 8.0
