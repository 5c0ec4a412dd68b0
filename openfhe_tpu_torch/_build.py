"""Build and load the port's CUDA kernels.

Each source in `csrc/` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface under `build/openfhe_tpu_torch/`
(next to the package), all sources in parallel, at first use. The library
name carries a hash of its source and of the shared headers
(`csrc/*.cuh`), so an edited source or header is rebuilt. The
libraries are loaded with `ctypes`; every entry point returns
`cudaGetLastError()`, which `record_launch` turns into an exception.

Every wrapper calls its entry point through `launch`, which runs it under
the card of its tensor operands and on that card's current stream, so a
tensor on a second card is never launched on the process's current one.

`LAUNCHES` counts, per kernel, the wrapper calls that launched it on the
card; the plain versions used for CPU tensors never count.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "openfhe_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# source -> {C entry point: argtypes}
SOURCES = {
    "ntt": {"ntt_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
            "ntt_inv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
            "ntt_fwd_staged": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
            "ntt_inv_staged": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _P]},
    "ntt_small": {"ntt_small_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
                  "ntt_small_inv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _P]},
    "rowmod": {"mod_matmul_rowmod": [_P] * 6 + [_I] * 4 + [_P],
               "mod_matmul_rowmod_eager": [_P] * 5 + [_I] * 4 + [_P]},
    "modmatmul": {"mod_matmul": [_P] * 5 + [_I] * 4 + [_P],
                  "mod_matmul_simt": [_P] * 4 + [_I] * 4 + [_P]},
    "ks_fused": {"tensor_intt": [_P] * 10 + [_I] * 2 + [_P],
                 "tensor_intt_staged": [_P] * 9 + [_I] * 2 + [_P],
                 "intt_scale": [_P] * 7 + [_I] * 5 + [_P],
                 "intt_scale_staged": [_P] * 7 + [_I] * 5 + [_P],
                 "conv_digits": [_P] * 6 + [_I] * 5 + [_P],
                 "conv_digits_rowmod": [_P] * 5 + [_I] * 4 + [_P],
                 "ntt_keymul_acc": [_P] * 10 + [_I] * 6 + [_P],
                 "intt_conv_p": [_P] * 12 + [_I] * 3 + [_P],
                 "ntt_keymul_acc_staged": [_P] * 11 + [_I] * 6 + [_P],
                 "intt_conv_p_staged": [_P] * 11 + [_I] * 3 + [_P],
                 "ntt_subscale": [_P] * 12 + [_I] * 4 + [_P],
                 "ntt_subscale_staged": [_P] * 13 + [_I] * 4 + [_P],
                 "ntt_submul_final": [_P] * 15 + [_I] * 5 + [_P],
                 "ntt_submul_final_staged": [_P] * 15 + [_I] * 5 + [_P]},
    "blind_rotate": {"blind_rotate_cggi": [_P] * 14 + [_I] * 6 + [_P],
                     "blind_rotate_dm": [_P] * 13 + [_I] * 6 + [_P],
                     "blind_rotate_lmkcdey": [_P] * 14 + [_I] * 6 + [_P]},
    "sharded": {"conv_digits_rows": [_P] * 6 + [_I] * 7 + [_P],
                "conv_digits_rows_rowmod": [_P] * 5 + [_I] * 4 + [_P],
                "conv_p_to_q_rows": [_P] * 6 + [_I] * 4 + [_P],
                "conv_p_to_q_rows_rowmod": [_P] * 5 + [_I] * 4 + [_P],
                "ntt_keymul_acc_rows": [_P] * 10 + [_I] * 6 + [_P],
                "ntt_keymul_acc_rows_staged": [_P] * 11 + [_I] * 6 + [_P]},
}

LAUNCHES: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class Built:
    libs: dict        # source name -> ctypes.CDLL
    log: dict         # source name -> nvcc output ("" when cached)
    seconds: float


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


@functools.lru_cache(maxsize=None)
def build() -> Built:
    """Compile (in parallel) and load every kernel library, once."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets, jobs = {}, {}
    headers = b"".join(h.read_bytes()
                       for h in sorted((_PKG / "csrc").glob("*.cuh")))
    for name in SOURCES:
        src = _PKG / "csrc" / f"{name}.cu"
        digest = hashlib.sha1(src.read_bytes() + headers).hexdigest()[:12]
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        targets[name] = so
        if not so.exists():
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp)
    log = {name: "" for name in SOURCES}
    failed = []
    for name, (proc, tmp) in jobs.items():
        log[name], _ = proc.communicate()
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(log[n] for n in failed))
    libs = {}
    for name, entries in SOURCES.items():
        lib = ctypes.CDLL(str(targets[name]))
        for fn, argtypes in entries.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return Built(libs=libs, log=log, seconds=time.perf_counter() - t0)


def entry(source: str, fn: str):
    """The C entry point `fn` of library `source` (building on first use)."""
    return getattr(build().libs[source], fn)


def launch(source: str, fn: str, *args) -> None:
    """Launch entry point `fn` of library `source` and count it.

    Tensors pass their data pointers and ints pass as they are; every
    tensor must lie on the card of the first one, under which the entry
    point runs, with that card's current stream as its last argument."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    card = tensors[0].get_device()
    if any(t.get_device() != card for t in tensors):
        where = sorted({str(t.device) for t in tensors})
        raise ValueError(f"{fn}: operands on {where}, expected one card")
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(card):
        rc = entry(source, fn)(*ptrs,
                               torch.cuda.current_stream(card).cuda_stream)
    record_launch(rc, fn)


def record_launch(rc: int, kernel: str) -> None:
    """Raise if a launch failed; else count it in LAUNCHES."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
    LAUNCHES[kernel] += 1
