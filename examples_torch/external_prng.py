"""Pluggable PRNG engine demo on the port.

Counterpart of `examples/external_prng.py` (reference core example
src/core/examples/external-prng.cpp): the reference lets a user dlopen an
external PRNG library and install it with
PseudoRandomNumberGenerator::InitPRNGEngine; here the hook is
`openfhe_tpu_torch.utils.prng.set_prng_factory`, which swaps the engine
behind every host sampling call. The engine's first words then seed a
`torch.Generator` on the GPU (unless `--device cpu`) that draws a few
discrete Gaussians there.

    python examples_torch/external_prng.py [--device cpu] [--external]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from openfhe_tpu_torch._device import resolve_device  # noqa: E402
from openfhe_tpu_torch.math.dgg import DiscreteGaussianGenerator  # noqa
from openfhe_tpu_torch.utils import prng  # noqa: E402


class CountingEngine:
    """A stand-in 'external' PRNG: deterministic counter stream.

    (For demonstration only: never use a non-cryptographic engine for
    real key material.)
    """

    def __init__(self, seed=None, counter=0):
        self._state = counter

    def __call__(self) -> int:
        self._state = (self._state + 0x9E3779B9) & 0xFFFFFFFF
        return self._state

    def random_uint32s(self, count):
        return np.array([self() for _ in range(count)], dtype=np.uint32)


def main(device=None, external: bool = False) -> dict:
    """Five draws in [0, 10] from the installed engine (the counting one
    with `external`), then eight Gaussians of sigma 3.19 on `device` from
    a generator the engine seeds; the built-in engine is restored."""
    dev = resolve_device(device)
    if external:
        print("==== Using external PRNG")
        prng.set_prng_factory(CountingEngine)
    else:
        print("==== Using the built-in BLAKE2b PRNG")
    try:
        engine = prng.get_prng()
        draws = [engine() % 11 for _ in range(5)]
        print("5 draws in [0, 10]:", draws)
        seed = (engine() << 32) | engine()
        gen = torch.Generator(device=dev).manual_seed(seed)
        gauss = DiscreteGaussianGenerator(3.19, generator=gen)
        vec = gauss.GenerateIntVector(8).cpu().numpy()
        print(f"8 Gaussians on {dev} from an engine-seeded generator:", vec)
    finally:
        # restore the default engine for any code that runs after us
        prng.set_prng_factory(None)
    return {"draws": draws, "seed": seed, "gaussians": vec}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--external", action="store_true",
                        help="install the demo counting engine")
    args = parser.parse_args()
    main(args.device, args.external)
