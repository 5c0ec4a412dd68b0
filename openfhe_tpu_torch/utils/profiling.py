"""Stage timers and device profiling hooks.

Counterpart of `openfhe_tpu/utils/profiling.py` (reference analog:
utils/debug.h:91-127, the TIC/TOC/PROFILELOG macros, and the
BOOTSTRAPTIMING stage prints of ckksrns-fhe.cpp). A wall-clock time of
device work must wait for the device: `TOC` synchronizes the CUDA device
of a result it is given. Deep traces come from `torch.profiler`
(`device_trace` writes a Chrome trace).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

PROFILE = bool(int(os.environ.get("OPENFHE_TPU_PROFILE", "0")))


def TIC() -> float:
    return time.perf_counter()


def _wait(result) -> None:
    """Wait for the CUDA work behind a tensor, or a tuple, list or object
    of tensors (a Ciphertext's elements)."""
    items = getattr(result, "elements", result)
    if isinstance(items, torch.Tensor):
        items = (items,)
    for x in items if isinstance(items, (tuple, list)) else ():
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)


def TOC(t0: float, result=None) -> float:
    """Elapsed seconds since t0, after the device work of `result` if
    given."""
    if result is not None:
        _wait(result)
    return time.perf_counter() - t0


def TOC_MS(t0: float, result=None) -> float:
    """Elapsed milliseconds (reference TOC_MS, utils/debug.h)."""
    return TOC(t0, result) * 1e3


def TOC_US(t0: float, result=None) -> float:
    """Elapsed microseconds (reference TOC_US, utils/debug.h)."""
    return TOC(t0, result) * 1e6


def profile_log(stage: str, seconds: float) -> None:
    if PROFILE:
        print(f"[openfhe-tpu] {stage}: {seconds * 1e3:.2f} ms", flush=True)


@contextlib.contextmanager
def stage(name: str):
    """`with stage("CoeffsToSlots"): ...` prints under
    OPENFHE_TPU_PROFILE=1 and costs nothing otherwise."""
    t0 = time.perf_counter()
    yield
    if PROFILE:
        profile_log(name, time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """A torch.profiler trace of the CPU and CUDA activity of the block,
    written as a Chrome trace `trace.json` under `logdir` (a new
    temporary directory when None), which the block receives."""
    logdir = logdir or tempfile.mkdtemp(prefix="openfhe_trace_")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
