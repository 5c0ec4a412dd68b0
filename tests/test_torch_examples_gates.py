"""The port's FHEW gate examples (`examples_torch/`) on the CPU, each at its
JAX counterpart's own parameters (TOY or its custom ring), every
decryption exactly its truth table
(`test_torch_examples_leveled.check_example`)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_examples_leveled import (check_example,  # noqa: E402
                                         one_thread)  # noqa: F401

SIX = ("AND", "OR", "NAND", "NOR", "XOR", "XNOR")


@pytest.mark.parametrize("name, labels", [
    ("boolean", ("AND", "OR", "NAND", "XOR", "NOT")),
    ("boolean_multi_input", ("AND3", "OR3", "MAJORITY", "CMUX")),
    ("boolean_pke", ("LARGE_DIM 1", "SMALL_DIM 1", "1 AND 1",
                     "(NOT 1) AND 1", "OR of both")),
    ("boolean_truth_tables", SIX + ("NOT",)),
    ("boolean_truth_tables_pke", SIX),
    ("eval_flooring_pke", ("floor",)),
])
def test_gate_example(name, labels):
    out = check_example(name, dict.fromkeys(labels))
    if "n" in out:
        assert (out["n"], out["N"]) == (64, 512)      # TOY
