"""Integer discrete-Gaussian sampling demo on the port.

Counterpart of `examples/sampling.py` (reference core example
src/core/examples/sampling.cpp): times the table / rounding sampler of
`math/dgg.py` (on the GPU unless `--device cpu`; the reference's
"rejection" and "Karney" rows) and the generic sampler of
`math/dgg_generic.py` over Peikert and Knuth-Yao base samplers (bit-serial
on the host), over a sweep of coset centers.

The base samplers get the constants PEIKERT and KNUTH_YAO. The JAX
example passes the strings "PEIKERT" and "KNUTH_YAO", which its
BaseSampler takes for Knuth-Yao both times, so its two generic rows time
one sampler; the port's BaseSampler refuses a string.

    python examples_torch/sampling.py [--device cpu]
"""
import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from openfhe_tpu_torch.math.dgg import DiscreteGaussianGenerator  # noqa
from openfhe_tpu_torch.math.dgg_generic import (  # noqa: E402
    KNUTH_YAO, PEIKERT, BaseSampler, BitGenerator,
    DiscreteGaussianGeneratorGeneric)

STD_BASE = 34
STD = float(1 << 22)
CENTER_COUNT = 64          # reference uses 1024; scaled for a quick demo
COUNT = 50                 # samples per center (reference: 1000)
SMOOTHING = 6


def main(device=None, center_count: int = CENTER_COUNT,
         count: int = COUNT) -> dict:
    """Sample `count` integers at each of `center_count` centers k /
    center_count, sigma STD, with each method; returns, per method, the
    samples ([center_count, count] int64) and the ms per center."""
    print(f"Distribution parameter = {STD}")
    dgg = DiscreteGaussianGenerator(4, device=device)
    dgg_rej = DiscreteGaussianGenerator(4, device=device)
    bg = BitGenerator()

    print("Started creating base samplers")
    peikert = [BaseSampler(i / center_count, STD_BASE, bg, PEIKERT)
               for i in range(center_count)]
    ky = [BaseSampler(i / center_count, STD_BASE, bg, KNUTH_YAO)
          for i in range(center_count)]
    print("Ended creating base samplers, Started sampling")
    base = int(math.log2(center_count))
    generic = {
        "Generic - Peikert": DiscreteGaussianGeneratorGeneric(
            peikert, STD_BASE, base, SMOOTHING),
        "Generic - Knuth Yao": DiscreteGaussianGeneratorGeneric(
            ky, STD_BASE, base, SMOOTHING)}

    def vector(c):
        centers = torch.full((count,), c, dtype=torch.float64,
                             device=dgg_rej.device)
        return dgg_rej.GenerateVector(count, centers, STD).cpu().numpy()

    methods = {
        "Rejection": vector,
        "Karney": lambda c: np.array([dgg.GenerateIntegerKarney(c, STD)
                                      for _ in range(count)]),
        **{name: (lambda c, g=g: np.array([g.generate_integer(c, STD)
                                           for _ in range(count)]))
           for name, g in generic.items()}}
    out = {}
    for name, fn in methods.items():
        t0 = time.perf_counter()
        samples = np.stack([fn(k / center_count)
                            for k in range(center_count)])
        ms = (time.perf_counter() - t0) * 1e3 / center_count
        print(f"Sampling {count} integers ({name}): {ms:.3f} ms")
        out[name] = {"samples": samples, "ms_per_center": ms}
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    main(parser.parse_args().device)
