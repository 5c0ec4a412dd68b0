"""The port's scheme-switching examples and its mesh example
(`examples_torch/`) on the CPU, each at its JAX counterpart's own
parameters (`test_torch_examples_leveled.check_example`).
EvalCKKStoFHEW's LWE decryptions are exact; the comparison's CKKS result
(0 or 1 a slot) is held to `tests/test_schemeswitch.py`'s 0.1, as the JAX
example asserts none; `parallel` runs on a mesh of CPU devices and is held
to its verified fill."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_examples_leveled import (check_example,  # noqa: E402
                                         one_thread)  # noqa: F401


@pytest.mark.parametrize("name, tols", [
    ("scheme_switching", {"CKKS->FHEW": None, "x1 < x2": 0.1}),
    ("scheme_switching_serial", {"restored": 1e-3}),
    ("parallel", {"sharded fill": None, "single fill": None}),
])
def test_switch_and_mesh_example(name, tols):
    out = check_example(name, tols)
    if name == "parallel":
        assert out["shards"] == 8
