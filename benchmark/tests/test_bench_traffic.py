"""The traffic generator: every mix is deterministic in its seed and gives
every seed the same work in another order."""

import collections
import json
from pathlib import Path

import numpy as np
import pytest

from harness import traffic

MIXES = sorted((Path(__file__).resolve().parent.parent / "traffic")
               .glob("*.json"))


def take(mix, seed, count):
    gen = traffic.requests(mix, seed)
    return [next(gen) for _ in range(count)]


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_each_mix_is_deterministic_in_its_seed(path):
    mix = json.loads(path.read_text())
    seed = 2 ** 31 + 12345
    a, b = take(mix, seed, 200), take(mix, seed, 200)
    c = take(mix, seed + 1, 200)
    for x, y in zip(a, b):
        assert x["index"] == y["index"] and x["level"] == y["level"]
        assert x["gate"] == y["gate"]
        np.testing.assert_array_equal(x["picks"], y["picks"])
    assert any(not np.array_equal(x["picks"], z["picks"])
               for x, z in zip(a, c))
    shape = (mix["operands"], mix.get("batch", 1))
    assert all(r["picks"].shape == shape for r in a)
    assert all(0 <= r["picks"].min() and r["picks"].max() < mix["pool"]
               for r in a)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_every_seed_gets_the_same_levels_and_gates(path):
    """Levels and gates run through permutations: over whole rounds each
    seed draws each one equally often."""
    mix = json.loads(path.read_text())
    for key in ("levels", "gates"):
        values = mix.get(key)
        if not values:
            continue
        rounds = 25 * len(values)
        field = key[:-1]
        counts = [collections.Counter(r[field] for r in take(mix, s, rounds))
                  for s in (1, 99, 2 ** 33)]
        assert all(c == {v: 25 for v in values} for c in counts)


def test_unknown_keys_are_refused():
    with pytest.raises(ValueError):
        traffic.check_mix({"request": "gate", "clients": 1, "pool": 2,
                           "operands": 1, "rate": 5})
