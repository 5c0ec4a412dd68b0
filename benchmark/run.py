"""One run of one cell of the benchmark of `openfhe_tpu_torch` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (`workloads` in BENCHMARK.json) names a configuration
(`configs/<config>.json`) and a traffic mix (`traffic/<mix>.json`). The
run makes the inputs from the seed, sets up the program
(`harness/systems/<the configuration's system>.py`), warms up one request
of each shape the mix takes, then runs the closed loop of
`harness/loop.py` for `seconds`. After the window it reads the peak
memory, decrypts what the adapter keeps, frees the program's state, runs
the reference (`reference/`) over a sample of each level's requests drawn
from the seed and compares their words, and prints as its last line one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
`end_to_end` metrics with `--trace 0`, its `per_layer` metrics with
`--trace 1`), `device`, with `--trace 1` `breakdown`, and last `checks`,
each number compared beside its limit (also the last lines of standard
error). Each metric is read by `metrics/<name>.py`, or by
`metrics/<the name before its first dot>.py`. It exits non-zero, with no
result, without as many CUDA cards as the cell asks for, or when JAX or
the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for path in (str(HERE), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

import torch  # noqa: E402

from harness import card, guard, loop, trace, traffic  # noqa: E402

LIMITS = {"mismatched_words": 0, "wrong_bits": 0}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str):
    """`read` of metrics/<name>.py, else of metrics/<stem>.py."""
    for stem in (name, name.split(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"bench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r}")


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """The metric entries this cell reports in this kind of run."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved
                             else [])]


def system_for(config: dict, mix: dict, seed: int, device):
    mod = importlib.import_module(f"harness.systems.{config['system']}")
    return mod.System(config, mix, seed, device)


def run_cell(config: dict, mix: dict, seed: int, seconds: float, device,
             traced: bool = False) -> dict:
    """Set up, warm up, run the window and check it: a dict of what the
    result line and the metric readers need. Set-up is timed from this
    module's first line, the process's start."""
    dev = torch.device(device)
    system = system_for(config, mix, seed, dev)
    requests = system.stream(traffic.requests(mix, seed))
    for _ in range(2):
        for req in system.warm_requests():
            system.issue(req)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T0
    tracer = trace.Tracer() if traced else None
    rec = loop.run(system, requests, mix, seconds, seed, tracer)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    checks = {}
    if rec.kept:
        checks.update(system.verify_all(rec.kept, rec.requests))
    summary = None
    if tracer is not None:
        dev_ops, host = tracer.events()
        own = trace.own_kernel_names(ROOT / "openfhe_tpu_torch" / "csrc")
        t = rec.traced
        summary = trace.summarize(dev_ops, host, own, t["window_s"])
        nbytes, ops = (sum(x) for x in zip(*(system.work(r)
                                             for r in t["requests"])))
        summary.update(requests=len(t["requests"]),
                       launches=t["launches"], bytes=nbytes, int_ops=ops)
    system.free_program()
    rec.kept = []
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = system.reference(rec.samples)
    bad = [int((system.words(s["out"]) != system.words(w)).sum())
           for s, w in zip(rec.samples, want)]
    checks["mismatched_words"] = sum(bad)
    checks["requests_compared"] = len(bad)
    return {"system": system, "rec": rec, "setup_s": setup_s,
            "memory_peak_bytes": peak, "checks": checks,
            "failed": sum(1 for b in bad if b) + checks.get(
                "wrong_requests", 0),
            "trace": summary, "reference_s": time.perf_counter() - t_ref}


def judge(checks: dict):
    """(each number compared with its limit, correct): correct when every
    number is within its limit and some request was compared."""
    compared = {k: {"value": checks[k], "limit": LIMITS[k]}
                for k in LIMITS if k in checks}
    ok = all(c["value"] <= c["limit"] for c in compared.values())
    return compared, ok and checks.get("requests_compared", 0) > 0


def view(out: dict, card_info: dict | None) -> dict:
    """What a metric reader sees."""
    rec = out["rec"]
    summary = out["trace"]
    if summary is not None and card_info is not None:
        summary = dict(summary, least_s=card.least_seconds(
            summary["bytes"], summary["int_ops"], card_info))
    return {"seconds": rec.seconds, "setup_s": out["setup_s"],
            "latencies_s": rec.latencies_s, "completed": rec.completed,
            "units": rec.units, "issue_s": rec.issue_s, "trace": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    traced = bool(args.trace)

    card_info = card.describe()
    print(f"card: {json.dumps(card_info)}")
    torch.set_num_threads(2)
    from openfhe_tpu_torch import _build
    _build.build()
    out = run_cell(config, mix, args.seed, args.seconds, "cuda", traced)
    rec, checks = out["rec"], out["checks"]

    lat = sorted(rec.latencies_s)
    cuts = [rec.t0 + rec.seconds * k / 4 for k in range(5)]
    quarters = [sum(1 for t in rec.done_at if lo < t <= hi)
                for lo, hi in zip(cuts, cuts[1:])]
    issue_q = []
    for lo, hi in zip(cuts, cuts[1:]):
        spans = [d for t, d in zip(rec.issue_at, rec.issue_s) if lo <= t < hi]
        issue_q.append(sum(spans) / len(spans) * 1e3 if spans else None)
    pcts = {p: lat[min(len(lat) - 1, int(p / 100 * len(lat)))] * 1e3
            for p in (50, 90, 95, 99, 100)} if lat else {}
    print(f"requests: {rec.completed} completed in the window, "
          f"{rec.issued} issued, {rec.late} completed after it; median "
          f"latency {statistics.median(lat) * 1e3 if lat else None} ms; "
          f"latency ms by percentile {pcts}; completed by quarter "
          f"{quarters}; mean issue ms by quarter {issue_q}; checks {checks}; "
          f"reference {out['reference_s']} s")
    issue_cpu_q = []
    for lo, hi in zip(cuts, cuts[1:]):
        spans = [d for t, d in zip(rec.issue_at, rec.issue_cpu_s)
                 if lo <= t < hi]
        issue_cpu_q.append(sum(spans) / len(spans) * 1e3 if spans else None)
    seconds = []
    for a, b in zip(rec.host, rec.host[1:]):
        dt = b[0] - a[0]
        done = sum(1 for t in rec.done_at if a[0] < t <= b[0])
        seconds.append([round(dt, 3), done, round((b[1] - a[1]) / dt, 3),
                        round((b[2] - a[2]) / dt, 3),
                        round((b[3] - a[3]) / dt, 3), b[4] - a[4]])
    print(f"host: process CPU {rec.cpu_s} s in the window, "
          f"{rec.completed / rec.cpu_s if rec.cpu_s else None} requests a "
          f"CPU second; mean issue CPU ms by quarter {issue_cpu_q}; by "
          "sample [wall s, completed, process CPU / wall, thread CPU / "
          f"wall, stolen core-s / wall, involuntary switches] {seconds}")
    seen = view(out, card_info)
    metrics = {}
    for m in cell_metrics(bench, args.workload, traced):
        value = reader(m["name"])(seen)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": None, "attempted": rec.issued,
              "failed": out["failed"], "metrics": metrics, "device": device}
    s = out["trace"]
    if s is not None:
        device.update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": s["device_ops"],
                               "idle_gaps": s["idle_gaps"]}
        print(f"traced: {s['requests']} requests, {s['ops']} device "
              f"operations, csrc launches (_build.LAUNCHES) {s['launches']} "
              f"= {s['launches'] / max(1, s['ops'])} of them; own kernels "
              f"{s['own_s']} s, plain {s['plain_s']} s; least time "
              f"{seen['trace']['least_s']} s at {card_info['power_limit_w']}"
              " W")
    compared, result["correct"] = judge(checks)
    result["card"] = card_info
    result["checks"] = compared
    found = guard.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in compared.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
