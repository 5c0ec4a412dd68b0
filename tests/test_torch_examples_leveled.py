"""The port's leveled CKKS examples (`examples_torch/`) on the CPU, each at
its JAX counterpart's own parameters.

Each example returns its decryptions beside the plain computation, with
the tolerance its JAX counterpart asserts (1e-3 where it asserts none);
`check_example` runs one, requires exactly the checks listed here with
those tolerances, and holds every one of them. The ops underneath are held
word for word against the JAX package by the earlier files
(`test_torch_leveled.py`, `_advanced.py`, `_rotate.py`, ...).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from examples_torch import failed, holds  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for the examples: at their small rings the
    intra-op threads save little wall time and burn about 4x the CPU,
    which the suite's other workers need (the files that import this
    fixture share it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_example(name: str, tols: dict, **kw) -> dict:
    """examples_torch/<name>.py's main on the CPU: its checks are `tols`
    (label -> tolerance, None for exact) and every one holds."""
    out = importlib.import_module(f"examples_torch.{name}").main(
        device="cpu", **kw)
    assert {label: tol for label, (_, _, tol) in out["checks"].items()} \
        == tols
    assert failed(out) == []
    return out


FASTROT = {f"CKKS fastrot(+{r})": 1e-3 for r in (1, 2, 3)}


@pytest.mark.parametrize("name, tols", [
    ("simple_complex_numbers", {"z*w": 1e-2, "z*1j": 1e-2,
                                "z+(1-2j)": 1e-2}),
    ("rotation", {"BFV rot(+1)": None, "BFV rot(+2)": None,
                  "BFV rot(-1)": None, **FASTROT}),
    ("inner_product", {"BFV <a,b>": None, "CKKS <a,b>": 1e-2}),
    ("linearwsum_evaluation", {"sum w_i*x_i": 1e-2}),
    ("polynomial_evaluation", {"f1(x)": 1e-2, "f2(x)": 1e-2}),
    ("function_evaluation", {"logistic": 1e-3, "sin": 1e-3}),
    ("advanced_real_numbers", {"FIXEDMANUAL x^3+x": 1e-3,
                               "FLEXIBLEAUTO x^3+x": 1e-3,
                               "fastrot(1)": 1e-3, "fastrot(2)": 1e-3,
                               "fastrot(3)": 1e-3}),
    ("advanced_real_numbers_128", {"automatic x^18+x^9+1": 1e-8,
                                   "manual x^18+x^9+1": 1e-8,
                                   "HYBRID rot(1)": 1e-8,
                                   "BV rot(1)": 1e-8, "fastrot(1)": 1e-8,
                                   "fastrot(2)": 1e-8, "fastrot(3)": 1e-8}),
    ("ckks_noise_flooding", {"flooded 2x^2": 5e-2}),
])
def test_leveled_example(name, tols):
    check_example(name, tols)


def test_the_checks_hold_nothing_else():
    """`holds`: exact where the tolerance is None, strictly within it
    otherwise, and never across shapes."""
    assert holds([1, 2], np.array([1, 2]), None)
    assert not holds([1, 2], [1, 3], None)
    assert holds([0.5], [0.5 + 1e-4], 1e-3)
    assert not holds([0.5], [0.5 + 1e-3], 1e-3)
    assert not holds([1, 2], [1, 2, 0], None)
