"""The traced window: torch.profiler over a stretch of the closed loop.

The reading follows `openfhe_tpu_torch/trace_evalmult.py` (device time by
kernel name, the port's own `csrc/` kernels against the plain torch ones,
the idle gaps between device operations), copied here so that the
yardstick stays as it is while the package changes.

The profiler runs one unrecorded warm-up step first (a profile that
records from its first call can miss the first kernels), then the
recorded step. The harness drains the card at both ends of the recorded
step, so every kernel in it belongs to a request issued in it. Host spans
are `torch.profiler.record_function` ranges the harness opens around its
calls into the program ("issue") and its waits for a request ("wait");
an idle gap is named by the span its middle falls in, "host" outside
both (the harness's own bookkeeping).
"""

from __future__ import annotations

import bisect
import collections
import re

import torch

TOP = 10
HOST_SPANS = ("issue", "wait")


def own_kernel_names(csrc) -> set:
    """The `__global__` function names of the program's CUDA sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        text = path.read_text()
        names.update(re.findall(
            r"__global__\s+(?:__launch_bounds__\([^)]*\)\s*)?void\s+"
            r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)", text))
    return names


def short_name(name: str, limit: int = 120) -> str:
    """A device operation's name without return type, anonymous namespace
    or parameters, cut to `limit` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    args = re.search(r"[\w>]\(", name)
    return (name[:args.start() + 1] if args else name)[:limit]


def kernel_base(name: str) -> str:
    """A demangled kernel name without its return type, namespaces,
    template arguments or parameters: `void (anonymous namespace)::
    keymul_cluster<16>(unsigned int const*, ...)` -> `keymul_cluster`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, 1)[0].strip().rsplit("::", 1)[-1]


class Tracer:
    """torch.profiler with one warm-up step and one recorded step."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        self.prof = torch.profiler.profile(activities=acts, schedule=sched)

    def start(self):
        self.prof.start()

    def step(self):
        torch.cuda.synchronize()
        self.prof.step()

    def stop(self):
        torch.cuda.synchronize()
        self.prof.stop()

    def events(self):
        """(device ops, host spans): lists of (name, start_ns, end_ns)."""
        dev, host = [], []
        try:
            evs = self.prof.profiler.kineto_results.events()
            rows = ((e.name(), e.device_type(), e.start_ns(), e.end_ns(),
                     e.is_user_annotation()) for e in evs)
        except AttributeError:
            rows = ((e.name, e.device_type, int(e.time_range.start * 1e3),
                     int(e.time_range.end * 1e3),
                     getattr(e, "is_user_annotation", False))
                    for e in self.prof.events())
        for name, kind, t0, t1, annot in rows:
            if kind == torch.autograd.DeviceType.CUDA:
                if not annot and not name.startswith("ProfilerStep"):
                    dev.append((name, t0, t1))
            elif name in HOST_SPANS:
                host.append((name, t0, t1))
        return dev, host


def summarize(dev: list, host: list, own: set, window_s: float) -> dict:
    """Busy seconds (the union of device operations), the port's own and
    the plain device seconds, device operations, the top operations by
    time and the longest idle gaps named by host span."""
    by_name = collections.Counter()
    own_s = 0.0
    for name, t0, t1 in dev:
        by_name[name] += (t1 - t0) * 1e-9
        if kernel_base(name) in own:
            own_s += (t1 - t0) * 1e-9
    spans = sorted((t0, t1) for _, t0, t1 in dev)
    busy, gaps, last = 0.0, [], None
    for t0, t1 in spans:
        if last is None or t0 > last:
            if last is not None:
                gaps.append((last, t0))
            busy += (t1 - t0) * 1e-9
            last = t1
        elif t1 > last:
            busy += (t1 - last) * 1e-9
            last = t1
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]

    def span_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return host[i][0] if i >= 0 and host[i][2] >= t else "host"

    named = sorted(((span_at((g0 + g1) // 2), (g1 - g0) * 1e-9)
                    for g0, g1 in gaps), key=lambda g: -g[1])
    total = sum(by_name.values())
    return {"busy_s": busy, "window_s": window_s, "ops": len(dev),
            "device_s": total, "own_s": own_s, "plain_s": total - own_s,
            "device_ops": [[short_name(n), s]
                           for n, s in by_name.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in named[:TOP]]}
