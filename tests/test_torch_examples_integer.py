"""The port's BGV / BFV, composite-scaling and serialization examples
(`examples_torch/`) on the CPU, each at its JAX counterpart's own
parameters: integer results exactly, CKKS within the JAX example's
asserted tolerance (`test_torch_examples_leveled.check_example`)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_examples_leveled import (check_example,  # noqa: E402
                                         one_thread)  # noqa: F401


@pytest.mark.parametrize("name, tols", [
    ("simple_integers_bgvrns", {"sum": None, "prod": None, "rot+1": None,
                                "rot-1": None}),
    ("depth_bfvrns", {"HPSPOVERQLEVELED/STANDARD": None,
                      "BEHZ/EXTENDED": None}),
    ("depth_bgvrns", {"FIXEDAUTO": None, "FLEXIBLEAUTO": None}),
    ("simple_real_numbers_composite_scaling",
     {"COMPOSITESCALINGAUTO": 1e-8, "COMPOSITESCALINGMANUAL": 1e-8}),
    ("simple_composite_scaling_manual",
     {label: 1e-8 for label in ("x1 + x2", "x1 - x2", "4 * x1", "x1 * x2",
                                "x1 rot(1)", "x1 rot(-2)", "x1 - 0.5",
                                "x1 + (-0.5)")}),
    ("polynomial_evaluation_high_precision_composite_scaling",
     {"poly1": 1e-8, "poly2": 1e-8}),
    ("simple_integers_serial", {"BFVRNS_SCHEME": None,
                                "BGVRNS_SCHEME": None}),
    ("simple_real_numbers_serial", {"x^2": 1e-2}),
])
def test_integer_and_composite_example(name, tols):
    out = check_example(name, tols)
    if name == "polynomial_evaluation_high_precision_composite_scaling":
        assert all(ms > 0 for ms in out["ms"].values())
