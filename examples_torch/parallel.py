"""Parallelism demo on the port: an array fill sharded over a device mesh.

Counterpart of `examples/parallel.py` (reference:
src/core/examples/parallel.cpp:67-182, whose `#pragma omp parallel for`
fill becomes data parallelism): the array is cut over a mesh of devices
(`openfhe_tpu_torch.parallel`: `Mesh`, `shard`, `unshard`), each device
fills its own part, and the result is verified, then timed against one
device doing the whole. On the card the mesh is every visible card; with
`--device cpu` it is a mesh of CPU devices:

    python examples_torch/parallel.py [--device cpu] [array_size]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from examples_torch import exact  # noqa: E402
from openfhe_tpu_torch import parallel as par  # noqa: E402
from openfhe_tpu_torch.utils.profiling import TIC, TOC_MS  # noqa: E402

CPU_SHARDS = 8      # the JAX package's virtual CPU mesh


def verify(foo: np.ndarray) -> bool:
    ok = bool(np.all(np.diff(foo) == 1))
    print("verification succeeded" if ok else "verification failed")
    return ok


def fill(x: torch.Tensor) -> torch.Tensor:
    """The loop body: a square root of a square, on one device's part."""
    return torch.sqrt(x.float() ** 2)


def main(device=None, array_size: int = 1 << 20) -> dict:
    """The sharded and the single-device fills of 0 ... array_size - 1
    beside what they should be, and both times in ms."""
    if device is None or torch.device(device).type == "cuda":
        devs = par.cards()               # raises when there is no card
    else:
        devs = [torch.device(device)] * CPU_SHARDS
    mesh = par.make_mesh(len(devs), devices=devs)
    n_dev = mesh.size
    print(f"Parallel computation demo over {n_dev} shard(s) on "
          f"{len(set(devs))} device(s): {mesh}")

    # pad to a multiple of the shard count (even cuts along the data axis)
    padded = (array_size + n_dev - 1) // n_dev * n_dev
    seed = torch.arange(padded, dtype=torch.int32)
    parts = par.shard(seed, mesh, ("limb",))
    for p in parts:                      # warm up outside the timer
        fill(p)

    t = TIC()
    filled = [fill(p) for p in parts]    # each device fills its own part
    sharded_ms = TOC_MS(t, filled)
    out = par.unshard(filled, mesh, ("limb",), device="cpu").numpy()
    print(f"Total time (sharded over {n_dev} shard(s)): {sharded_ms:.3f} ms")
    ok = verify(out[:array_size])

    # the single-device comparison run (the reference's serial baseline)
    single = seed.to(devs[0])
    fill(single)
    t = TIC()
    one = fill(single)
    single_ms = TOC_MS(t, one)
    print(f"Total time (single device):            {single_ms:.3f} ms")
    ok_one = verify(one.cpu().numpy()[:array_size])
    assert ok and ok_one

    # the host timers (reference TIC/TOC + PROFILELOG)
    t = TIC()
    time.sleep(0.01)
    print(f"\nPROFILELOG demo: a 10 ms host sleep measured as "
          f"{TOC_MS(t):.1f} ms")
    want = np.arange(array_size, dtype=np.float32)
    return {"checks": {"sharded fill": exact(out[:array_size], want),
                       "single fill": exact(one.cpu().numpy()[:array_size],
                                            want)},
            "ms": {"sharded": sharded_ms, "single": single_ms},
            "shards": n_dev}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("array_size", nargs="?", type=int, default=1 << 20)
    args = parser.parse_args()
    main(args.device, args.array_size)
