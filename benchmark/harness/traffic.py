"""The one traffic generator: a mix file's parameters -> the requests.

A mix (`traffic/<name>.json`) names its request kind and its parameters:

    request   the kind the system adapter runs ("mult_rescale", ...)
    clients   requests in flight at once (a closed loop: a client sends its
              next request when its last one is seen complete)
    levels    CKKS levels the requests take, each equally often
    gates     gates the requests evaluate, each equally often
    pool      inputs made in set-up (per level, where there are levels)
    operands  pool inputs a request draws, each of `batch` ciphertexts
    batch     ciphertexts an operand holds (gates a request: batch)
    chain     the request's first operand is the previous output
    rotations hoisted rotations a linear-transform request runs
    sample    requests of each level (of the whole stream, where there are
              no levels) whose answers a run recomputes with the reference
    trace_seconds  the length of the traced stretch of a `--trace 1` run

Levels and gates run through seeded permutations, a fresh one each round,
so every seed gives the same amount of each kind of work in another order.
Operands are drawn uniformly from the pool. The same seed gives the same
requests.
"""

from __future__ import annotations

import itertools

import numpy as np

KEYS = {"request", "clients", "levels", "gates", "pool", "operands", "batch",
        "chain", "rotations", "sample", "trace_seconds", "why"}


def check_mix(mix: dict) -> None:
    unknown = set(mix) - KEYS
    if unknown:
        raise ValueError(f"unknown traffic keys: {sorted(unknown)}")
    for key in ("request", "clients", "pool", "operands"):
        if key not in mix:
            raise ValueError(f"traffic without {key!r}")


def _cycled(rng: np.random.Generator, values):
    """Values in a fresh seeded permutation each round."""
    values = list(values)
    while True:
        for i in rng.permutation(len(values)):
            yield values[i]


def requests(mix: dict, seed: int):
    """An endless iterator of request dicts: index, level (or None), gate
    (or None) and picks [operands, batch] int64 pool indices."""
    check_mix(mix)
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0x7A1F])
    levels = _cycled(rng, mix["levels"]) if mix.get("levels") else None
    gates = _cycled(rng, mix["gates"]) if mix.get("gates") else None
    shape = (mix["operands"], mix.get("batch", 1))
    for i in itertools.count():
        yield {"index": i,
               "level": next(levels) if levels else None,
               "gate": next(gates) if gates else None,
               "picks": rng.integers(0, mix["pool"], size=shape)}
