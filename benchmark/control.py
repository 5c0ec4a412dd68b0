"""The control of a cell's `correct`: the reference put in the program's
place, its modular products rounded through float64 (53 bits) instead of
exact int64, against the exact reference on the same inputs.

    python3 benchmark/control.py --workload <cell> --seed <n> [<n> ...]

For each seed it makes the cell's inputs, takes the first `sample`
requests of each level of the mix (of the mix, where it has no levels;
unchained: each gate's first input from the pool),
and prints one JSON line: the words the control gets wrong
(`mismatched_words`, the number a run compares) out of those compared
and, for gates, the bits its answers decrypt to wrongly. The benchmark's
own runs never run it; a correct control reads more than the limit 0.
"""

import argparse
import collections
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for path in (str(HERE), str(HERE.parent)):
    if path not in sys.path:
        sys.path.insert(0, path)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import run  # noqa: E402
from harness import traffic  # noqa: E402
from reference import binfhe as rbin  # noqa: E402
from reference.ntt import Exact, Float64  # noqa: E402


def first_of_each_level(mix: dict, seed: int) -> list:
    """The first `sample` requests of each level the mix takes (of the
    whole mix where it has none), as a run's sample holds them."""
    size = mix.get("sample", 4)
    want = size * len(mix.get("levels") or [None])
    taken, got = collections.Counter(), []
    for req in traffic.requests(mix, seed):
        if taken[req["level"]] < size:
            taken[req["level"]] += 1
            got.append(req)
            if len(got) == want:
                return got


def control(config: dict, mix: dict, seed: int, device) -> dict:
    system = run.system_for(config, mix, seed, torch.device(device))
    records = [{"req": req, "prev": None, "out": None}
               for req in first_of_each_level(mix, seed)]
    system.free_program()
    exact = system.reference(records, Exact)
    ctrl = system.reference(records, Float64)
    words = [system.words(c) != system.words(e) for c, e in zip(ctrl, exact)]
    out = {"seed": seed, "mismatched_words": int(sum(w.sum() for w in words)),
           "words_compared": int(sum(w.numel() for w in words)),
           "requests": len(records)}
    if config["system"] == "binfhe":
        got = np.concatenate([rbin.decrypt(a, b, system.s, system.q)
                              .cpu().numpy() for a, b in ctrl])
        want = np.concatenate([
            system.expected([r["req"]])[r["req"]["index"]]
            for r in records]).astype(np.int64)
        out["wrong_bits"] = int((got != want).sum())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = run.load_json(HERE.parent / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = run.load_json(HERE.parent / configs[cell["config"]]["file"])
    mix = run.load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seed:
        print(json.dumps(dict(control(config, mix, seed, "cuda"),
                              workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
