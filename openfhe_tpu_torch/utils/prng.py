"""BLAKE2-based counter-mode PRNG + pluggable PRNG interface.

Counterpart of `openfhe_tpu/utils/prng.py`, a copy on the host with its
own registry (a factory installed here does not reach the JAX package's,
nor the other way round). Reference analog: blake2engine.h
(Blake2Engine: BLAKE2b in counter mode, thread-local instance) and
prng.h (a pluggable external PRNG).

The port's device-side randomness rides `torch.Generator`s
(`math/draws.py`, `math/sampling.py`). This host engine feeds the
bit-serial generic sampler (`math/dgg_generic.py`) and external-PRNG
plugging; it uses the stdlib blake2b, so a seeded engine gives the same
words as the JAX package's.
"""

from __future__ import annotations

import hashlib
import os
import threading

import numpy as np

PRNG_BUFFER_SIZE = 1024        # reference blake2engine.h m_buffer


class Blake2Engine:
    """(reference Blake2Engine) counter-mode BLAKE2b keyed stream of
    uint32 words; API mirrors a C++ UniformRandomBitGenerator."""

    def __init__(self, seed=None, counter: int = 0):
        if seed is None:
            seed = np.frombuffer(os.urandom(64), np.uint8)
        seed = np.asarray(seed, np.uint8).tobytes()[:64]
        self._key = seed.ljust(64, b"\0")
        self._counter = counter
        self._buffer: list = []

    def _refill(self) -> None:
        h = hashlib.blake2b(
            self._counter.to_bytes(8, "little"), key=self._key,
            digest_size=64)
        words = np.frombuffer(h.digest(), np.uint32)
        self._buffer = list(words)
        self._counter += 1

    def __call__(self) -> int:
        """Next uint32 (reference operator())."""
        if not self._buffer:
            self._refill()
        return int(self._buffer.pop())

    def random_uint32s(self, count: int) -> np.ndarray:
        out = np.empty(count, np.uint32)
        for i in range(count):
            out[i] = self()
        return out

    min_value = 0
    max_value = 0xFFFFFFFF


class _PRNGRegistry:
    """Thread-local engine registry (reference
    PseudoRandomNumberGenerator::GetPRNG with external-PRNG plugging)."""

    def __init__(self):
        self._local = threading.local()
        self._factory = Blake2Engine

    def set_factory(self, factory) -> None:
        """Plug an external PRNG (reference InitPRNGEngine)."""
        self._factory = factory
        if hasattr(self._local, "engine"):
            del self._local.engine

    def get(self) -> Blake2Engine:
        if not hasattr(self._local, "engine"):
            self._local.engine = self._factory()
        return self._local.engine


PseudoRandomNumberGenerator = _PRNGRegistry()


def get_prng() -> Blake2Engine:
    return PseudoRandomNumberGenerator.get()


def set_prng_factory(factory) -> None:
    """Install an external PRNG engine class (reference InitPRNGEngine,
    distributiongenerator.h). Pass None to restore the built-in engine."""
    PseudoRandomNumberGenerator.set_factory(factory or Blake2Engine)
