"""Each cell driven on the CPU at a small size: the reference agrees word
for word with the port's plain path, the control (the reference's
products rounded through float64) does not, and a run whose timed path is
broken underneath comes out not correct."""

import collections
import dataclasses

import pytest
import torch

import control
import run
import small
from openfhe_tpu_torch.binfhe.context import BinFHEContext
from openfhe_tpu_torch.pke.context import CryptoContext

SEED = 2 ** 31 + 77


def run_small(name, seconds=0.5):
    make, mix = small.CELLS[name]
    out = run.run_cell(make(), mix, SEED, seconds, "cpu")
    return out, run.judge(out["checks"])[1]


@pytest.mark.parametrize("name", sorted(small.CELLS))
def test_reference_agrees_with_the_ports_plain_path(name):
    out, correct = run_small(name)
    checks = out["checks"]
    assert correct, checks
    assert checks["mismatched_words"] == 0
    rec, mix = out["rec"], small.CELLS[name][1]
    levels = collections.Counter(r["level"] for r in rec.requests)
    assert checks["requests_compared"] == sum(
        min(mix["sample"], k) for k in levels.values())
    assert {r["req"]["level"] for r in rec.samples} == set(levels)
    assert checks.get("wrong_bits", 0) == 0
    assert out["rec"].issued > 0


@pytest.mark.parametrize("name", ["mult", "and"])
def test_the_control_fails(name):
    """At 27-bit P towers float64 products stay below 2^53 at this small
    ring, so the CKKS control takes 30-bit P towers, whose products pass
    it as the cell's 27-bit towers near 2^27 do."""
    make, mix = small.CELLS[name]
    config = small.ckks(aux_bits=30) if name == "mult" else make()
    got = control.control(config, mix, SEED, "cpu")
    assert got["mismatched_words"] > 0, got


def _altered(out):
    """An answer with one word changed where it is produced."""
    if hasattr(out, "elements"):
        c0 = out.elements[0].clone()
        c0[0, 0] = (c0[0, 0] + 1) % 3
        return dataclasses.replace(out, elements=(c0,) + out.elements[1:])
    b = out.b.clone()
    b[0] = (b[0] + out.modulus // 4) % out.modulus
    return out.replace(b=b)


def _half_batch(gate):
    """The batch's first half evaluated, its answers repeated for the
    rest."""
    def broken(self, g, a, b):
        half = a.a.shape[0] // 2
        cut = lambda ct: ct.replace(a=ct.a[:half], b=ct.b[:half])
        out = gate(self, g, cut(a), cut(b))
        return out.replace(a=torch.cat([out.a, out.a]),
                           b=torch.cat([out.b, out.b]))
    return broken


FAULTS = {
    # a step that returns its state unchanged
    ("mult", "unchanged"): (CryptoContext, "EvalMult",
                            lambda f: lambda self, a, b: a),
    ("and", "unchanged"): (BinFHEContext, "EvalBinGate",
                           lambda f: lambda self, g, a, b: b),
    # half of the batch left out
    ("and", "half_batch"): (BinFHEContext, "EvalBinGate", _half_batch),
    # an answer altered where it is produced
    ("mult", "altered"): (CryptoContext, "Rescale",
                          lambda f: lambda self, ct, *k: _altered(
                              f(self, ct, *k))),
    ("hoisted", "altered"): (CryptoContext, "EvalFastRotation",
                             lambda f: lambda self, *a: _altered(
                                 f(self, *a))),
    ("chain", "altered"): (BinFHEContext, "EvalBinGate",
                           lambda f: lambda self, *a: _altered(
                               f(self, *a))),
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    cls, name, wrap = FAULTS[(cell, fault)]
    monkeypatch.setattr(cls, name, wrap(getattr(cls, name)))
    out, correct = run_small(cell, seconds=0.3)
    assert not correct, out["checks"]
