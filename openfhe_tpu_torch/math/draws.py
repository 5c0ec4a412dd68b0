"""Where the lattice toolbox's samplers take their variates from.

The JAX package's samplers (`math/dgg.py`, `lattice/dgsampling.py`,
`lattice/trapdoor.py`, `lattice/ringq.py`) draw from a
`numpy.random.Generator`: `rng.random`, `rng.normal` and `rng.integers`.
The port's take every variate through a draw source with three methods,
each returning a tensor on the source's `device`:

    random(n)              n float64 uniforms on [0, 1)
    normal(shape)          float64 standard normals of that shape
    integers(low, high, n) n int64 uniforms on [low, high)

`TorchDraws` is backed by a `torch.Generator` on the operands' card (or
the CPU, when asked). `ReplayDraws` hands back recorded variates in
order, so the port's cores can be held word for word to another run on
the same stream: the tests record what the JAX functions drew,
`chip_smoke.py` what the card drew (`RecordingDraws`). The samplers do
their own affine step on the standard normals (numpy's `normal(loc,
scale)` is `loc + scale * standard_normal` on the same stream).
"""

from __future__ import annotations

import numpy as np
import torch

from openfhe_tpu_torch._device import resolve_device


class TorchDraws:
    """Variates from a `torch.Generator`, on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = torch.device(generator.device)

    def random(self, n: int) -> torch.Tensor:
        return torch.rand(n, generator=self.generator, device=self.device,
                          dtype=torch.float64)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator,
                           device=self.device, dtype=torch.float64)

    def integers(self, low: int, high: int, n: int) -> torch.Tensor:
        return torch.randint(low, high, (n,), generator=self.generator,
                             device=self.device, dtype=torch.int64)


def torch_draws(device=None, seed: int | None = None) -> TorchDraws:
    """A `TorchDraws` on `device` (the GPU when None; raises when there is
    none), seeded with `seed` or from the system's entropy."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    if seed is None:
        gen.seed()
    else:
        gen.manual_seed(seed)
    return TorchDraws(gen)


_DTYPES = {"random": torch.float64, "normal": torch.float64,
           "integers": torch.int64}


class ReplayDraws:
    """Recorded variates handed back in order on `device`. `recorded` is
    a list of (kind, numpy array) with kind "random", "normal" or
    "integers"; a call of another kind or shape than the next record
    raises, so a core that draws in another order than the recorded run
    fails loudly."""

    def __init__(self, recorded, device):
        self.recorded = list(recorded)
        self.device = torch.device(device)
        self.taken = 0

    def _take(self, kind: str, shape) -> torch.Tensor:
        if self.taken >= len(self.recorded):
            raise IndexError(f"replay: no record left for {kind}{shape}")
        got, vals = self.recorded[self.taken]
        vals = np.asarray(vals)
        if got != kind or tuple(vals.shape) != tuple(shape):
            raise ValueError(f"replay: record {self.taken} is {got}"
                             f"{tuple(vals.shape)}, asked for {kind}"
                             f"{tuple(shape)}")
        self.taken += 1
        return torch.as_tensor(vals, dtype=_DTYPES[kind], device=self.device)

    def random(self, n: int) -> torch.Tensor:
        return self._take("random", (n,))

    def normal(self, shape) -> torch.Tensor:
        return self._take("normal", _shape(shape))

    def integers(self, low: int, high: int, n: int) -> torch.Tensor:
        return self._take("integers", (n,))

    def exhausted(self) -> bool:
        return self.taken == len(self.recorded)


class RecordingDraws:
    """Another source's variates, each kept (as numpy) in `recorded`."""

    def __init__(self, source):
        self.source = source
        self.device = source.device
        self.recorded: list = []

    def _keep(self, kind: str, vals: torch.Tensor) -> torch.Tensor:
        self.recorded.append((kind, vals.cpu().numpy()))
        return vals

    def random(self, n: int) -> torch.Tensor:
        return self._keep("random", self.source.random(n))

    def normal(self, shape) -> torch.Tensor:
        return self._keep("normal", self.source.normal(shape))

    def integers(self, low: int, high: int, n: int) -> torch.Tensor:
        return self._keep("integers", self.source.integers(low, high, n))


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)
