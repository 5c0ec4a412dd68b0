"""The port's serialized FHEW examples (`examples_torch/`) on the CPU, each
at its JAX counterpart's own parameters, binary and JSON, every
decryption exact (`test_torch_examples_leveled.check_example`); their
files go to a temporary directory that is gone afterwards."""

import tempfile

import pytest

torch = pytest.importorskip("torch")

from test_torch_examples_leveled import (check_example,  # noqa: E402
                                         one_thread)  # noqa: F401


@pytest.mark.parametrize("name, labels", [
    ("boolean_serial", ("bin OR(1,0)", "json OR(1,0)")),
    ("boolean_serial_pke", ("bin OR(1,0)", "json OR(1,0)")),
    ("boolean_serial_large_precision", ("bin floor", "json floor")),
])
def test_binfhe_serial_example(name, labels, monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    check_example(name, dict.fromkeys(labels))
    assert list(tmp_path.iterdir()) == []
