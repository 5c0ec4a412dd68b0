"""The port's AP, LMKCDEY and functional-bootstrap FHEW examples
(`examples_torch/`) on the CPU, each at its JAX counterpart's own
parameters, every decryption exact
(`test_torch_examples_leveled.check_example`)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_examples_leveled import (check_example,  # noqa: E402
                                         one_thread)  # noqa: F401


@pytest.mark.parametrize("name, labels", [
    ("boolean_ap", ("AND", "OR", "NAND")),
    ("boolean_ap_pke", ("1 AND 1", "1 NAND 1")),
    ("boolean_lmkcdey", ("AND", "XOR")),
    ("eval_function_binfhe", ("x^2 mod p",)),
    ("eval_function_pke", ("x^3 mod p",)),
    ("eval_sign_floor_decomp", ("sign(2)", "sign(13)", "floor(13 >> 2)",
                                "decomp(11)")),
])
def test_binfhe_method_example(name, labels):
    out = check_example(name, dict.fromkeys(labels))
    if name == "boolean_lmkcdey":
        assert (out["n"], out["N"]) == (64, 1024)     # the custom ring
