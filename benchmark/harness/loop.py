"""The closed loop that every cell runs, and what it records.

`clients` requests are in flight at once. The harness issues a request
(its host span "issue" runs from the call into the program to its
return), records an event on the card's stream behind it, and issues the
next while fewer than `clients` are in flight; otherwise it waits for the
oldest request's event (the span "wait"). A request's latency runs from
its issue to its event seen complete. The window is `seconds` long from
the first issue; the rate counts the requests completed in it and the
tail is taken over all of them. Requests still in flight when it closes
are waited for and checked, but not counted.

With a tracer, a stretch of `trace_seconds` in the middle of the window
is traced: the card is drained, the profiler's warm-up step runs the loop
for a moment, the recorded step runs it for `trace_seconds`, and the card
is drained again, so the recorded step holds exactly the kernels of the
requests issued in it.

A reservoir sample of `sample` requests of each level (of the whole
stream where the mix has no levels), drawn from the seed, keeps each
sampled request's answer (and the answer it was chained to) for the
reference, so that every run compares every level the mix takes; a
second one, of the adapter's `keep_count` requests, keeps answers for
the adapter's own check (gates: their decryptions). Answers that leave
both are freed, as a server frees what it has sent, so the card's memory
does not grow over the window.

Python's garbage collector is kept out of the window: what set-up made is
frozen (`gc.freeze`) and collection is off until the window and its
drain are over, so no collection of the set-up's objects lands in the
window at a moment that differs from run to run.

About once a second the loop samples the host (the process's and the
issuing thread's CPU time, the cores' stolen time, involuntary context
switches), and it times each issue on the thread's CPU clock too, so that
a run can tell a host that ran slower from one that was held up.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import random
import resource
import time

import torch

TRACE_WARMUP_S = 0.2
HOST_SAMPLE_S = 1.0


@dataclasses.dataclass
class Record:
    seconds: float
    latencies_s: list = dataclasses.field(default_factory=list)
    issue_s: list = dataclasses.field(default_factory=list)
    issue_at: list = dataclasses.field(default_factory=list)
    issue_cpu_s: list = dataclasses.field(default_factory=list)
    host: list = dataclasses.field(default_factory=list)
    cpu_s: float = 0.0
    issued: int = 0
    completed: int = 0
    units: int = 0
    late: int = 0
    samples: list = dataclasses.field(default_factory=list)
    kept: list = dataclasses.field(default_factory=list)
    requests: list = dataclasses.field(default_factory=list)
    done_at: list = dataclasses.field(default_factory=list)
    t0: float = 0.0
    traced: dict | None = None


class _Done:
    """A CPU stand-in for a CUDA event: complete at once."""

    def record(self):
        pass

    def synchronize(self):
        pass


def _event(device):
    return torch.cuda.Event() if device.type == "cuda" else _Done()


def _steal_s() -> float:
    """Seconds of CPU stolen from this machine's cores by its host (the
    `steal` column of /proc/stat, summed over the cores), or 0."""
    try:
        with open("/proc/stat") as f:
            return int(f.readline().split()[8]) / 100.0
    except (OSError, IndexError, ValueError):
        return 0.0


def host_sample(t: float) -> tuple:
    """(wall, process CPU, issuing thread's CPU, stolen, involuntary
    context switches) at wall time t."""
    return (t, time.process_time(), time.thread_time(), _steal_s(),
            resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """The closed loop's state: the requests in flight and the record."""

    def __init__(self, system, requests, mix: dict, seconds: float,
                 seed: int):
        self.system, self.requests, self.mix = system, requests, mix
        self.dev = system.device
        self.clients = mix["clients"]
        self.rec = Record(seconds=seconds)
        self.pick = random.Random(seed ^ 0x5EED5)
        self.sample = mix.get("sample", 4)
        self.strata = collections.defaultdict(list)   # level -> held
        self.seen = collections.Counter()               # level -> issued
        self.keep = getattr(system, "keep_count", 0)
        self.flight = collections.deque()
        self.prev = None
        self.spans = False
        self.next_sample = 0.0

    def span(self, name):
        return (torch.profiler.record_function(name) if self.spans
                else contextlib.nullcontext())

    def issue(self, counted=True):
        rec, req = self.rec, next(self.requests)
        t, c = time.perf_counter(), time.thread_time()
        with self.span("issue"):
            out = self.system.issue(req, self.prev)
        ev = _event(self.dev)
        ev.record()
        if counted:
            rec.issue_s.append(time.perf_counter() - t)
            rec.issue_cpu_s.append(time.thread_time() - c)
            rec.issue_at.append(t)
        level = req["level"]
        self._reservoir(self.strata[level], self.sample, self.seen[level],
                        {"req": req, "out": out, "prev": self.prev})
        self.seen[level] += 1
        self._reservoir(rec.kept, self.keep, rec.issued, (req, out))
        rec.requests.append(req)
        rec.issued += 1
        self.prev = out
        self.flight.append((t, ev))
        return req

    def _reservoir(self, held, size, i, entry):
        """The i-th request (from 0) takes one of `size` places with
        chance size / (i + 1)."""
        if i < size:
            held.append(entry)
        elif size:
            j = self.pick.randrange(i + 1)
            if j < size:
                held[j] = entry

    def complete(self, end):
        t, ev = self.flight.popleft()
        with self.span("wait"):
            ev.synchronize()
        done = time.perf_counter()
        rec = self.rec
        rec.done_at.append(done)
        if done <= end:
            rec.latencies_s.append(done - t)
            rec.completed += 1
            rec.units += self.system.units_per_request
        else:
            rec.late += 1

    def drain(self, end):
        while self.flight:
            self.complete(end)

    def run_until(self, stop, end, counted=True, issued=None):
        while (now := time.perf_counter()) < stop:
            if now >= self.next_sample:
                self.rec.host.append(host_sample(now))
                self.next_sample = now + HOST_SAMPLE_S
            if len(self.flight) < self.clients:
                req = self.issue(counted)
                if issued is not None:
                    issued.append(req)
            else:
                self.complete(end)

    def traced(self, tracer, end) -> dict:
        """The traced stretch (see the module): its requests, its length
        and the program's kernel launches in it."""
        self.drain(end)
        self.spans = True
        tracer.start()
        self.run_until(time.perf_counter() + TRACE_WARMUP_S, end, False)
        self.drain(end)
        tracer.step()
        launches0 = self.system.launches()
        reqs = []
        t0 = time.perf_counter()
        self.run_until(t0 + self.mix.get("trace_seconds", 1.0), end, False,
                       reqs)
        self.drain(end)
        _sync(self.dev)
        window = time.perf_counter() - t0
        launches = self.system.launches() - launches0
        tracer.step()
        tracer.stop()
        self.spans = False
        return {"requests": reqs, "window_s": window, "launches": launches}


def run(system, requests, mix: dict, seconds: float, seed: int,
        tracer=None) -> Record:
    """Drive `system` with `requests` for `seconds`; see the module."""
    loop = Loop(system, requests, mix, seconds, seed)
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        t0 = loop.rec.t0 = time.perf_counter()
        cpu0 = time.process_time()
        end = t0 + seconds
        trace_at = t0 + max(0.0, seconds - mix.get("trace_seconds", 1.0)) / 2
        if tracer is not None:
            loop.run_until(trace_at, end)
            loop.rec.traced = loop.traced(tracer, end)
        loop.run_until(end, end)
        loop.rec.cpu_s = time.process_time() - cpu0
        loop.rec.host.append(host_sample(time.perf_counter()))
        loop.drain(end)
        _sync(system.device)
    finally:
        gc.enable()
    rec = loop.rec
    rec.samples = [e for level in sorted(loop.strata,
                                         key=lambda k: -1 if k is None else k)
                   for e in loop.strata[level]]
    return rec
