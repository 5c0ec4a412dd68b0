"""Where an op's time goes on the card: a torch.profiler trace.

    python3 -m openfhe_tpu_torch.trace_evalmult --op relinearize

Builds the main path's context (N=2^16, 31 Q + 16 P towers, 2 digits),
warms up, then traces 5 calls of one op at level 0: `--op evalmult` (the
default; the fused mult chain of `pke/keyswitch/ks_fused.py`),
`relinearize` (of an EvalMultNoRelin product) or `rotate` (EvalRotate by
1), both through the general fused chain, `keyswitch_core_fused`. Prints
the device time of every kernel name (summed over the 5 calls, divided by
5) with its launches per call, the share taken by the port's own kernels
(`csrc/`) against the plain torch ops around them, and the device's busy
share of the wall time measured with CUDA events. Needs a CUDA card;
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys

import numpy as np
import torch

CALLS = 5
# kernel function names of csrc/ (ntt_core.cuh, rowmod_core.cuh, ks_fused.cu)
OWN = ("fwd_stage", "fwd_tile", "inv_stage", "inv_tile", "rowmod",
       "tensor_intt_tile", "keymul_tile", "subscale_tile", "submul_tile")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op", choices=("evalmult", "relinearize", "rotate"),
                    default="evalmult")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch import _build
    from openfhe_tpu_torch.pke.parameters import main_path_params

    _build.build()
    cc = fhe.GenCryptoContext(main_path_params(), seed=7)
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)
    z = np.random.default_rng(0).uniform(-0.5, 0.5, size=cc.slots)
    pt = cc.MakeCKKSPackedPlaintext(z)
    a, b = cc.Encrypt(kp.public_key, pt), cc.Encrypt(kp.public_key, pt)
    if args.op == "evalmult":
        op = lambda: cc.EvalMult(a, b)
    elif args.op == "relinearize":
        prod3 = cc.EvalMultNoRelin(a, b)
        op = lambda: cc.Relinearize(prod3)
    else:
        cc.EvalRotateKeyGen(kp.secret_key, [1])
        op = lambda: cc.EvalRotate(a, 1)
    for _ in range(3):
        op()
    torch.cuda.synchronize()

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        op()
    end.record()
    end.synchronize()
    wall_ms = start.elapsed_time(end) / CALLS

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(CALLS):
            op()
        torch.cuda.synchronize()
    per_name = collections.Counter()
    launches = collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_name[ev.name] += ev.time_range.elapsed_us() / 1e3 / CALLS
            launches[ev.name] += 1
    busy_ms = sum(per_name.values())
    own_ms = sum(t for name, t in per_name.items()
                 if any(f"{o}(" in name or f"{o}<" in name for o in OWN))
    print(f"{args.op} wall {wall_ms:.3f} ms (CUDA events, mean of {CALLS})")
    if not per_name:
        print("the profiler recorded no device time: busy share not measured")
        return 1
    for name, t in per_name.most_common(20):
        print(f"  {t:8.4f} ms  {launches[name] // CALLS:4d} launches  "
              f"{name[:90]}")
    print(json.dumps({
        "op": args.op, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "own_kernels_ms": own_ms,
        "kernel_launches": sum(launches.values()) // CALLS,
        "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
