"""Generic (constant-time-structured) discrete Gaussian sampler.

Counterpart of `openfhe_tpu/math/dgg_generic.py`, a copy on the host
(reference analog: discretegaussiangeneratorgeneric.{h,cpp}, the UCSD
"generic sampler", Micciancio-Walter 2017): 2^b base samplers at
fractional centers i/2^b are combined (SamplerCombiner ladders for large
variance, randomized Bernoulli rounding of the center bits, and the
SampleC base-b recurrence) to hit any (center, stddev) pair at runtime.

Base samplers come in PEIKERT (inversion CDF table) and KNUTH_YAO (DDG
tree walk) flavors, bit-fed by the port's BLAKE2 counter PRNG
(`utils/prng.py`). It is bit-serial and stays on the host: fed the same
seeded engine, it gives the JAX package's integers one for one. The
vectorised sampler on the card is `math/dgg.py`'s.

One difference: `BaseSampler` refuses a `b_type` that is neither
KNUTH_YAO nor PEIKERT, where the JAX package builds a Knuth-Yao sampler
for any other value (its `examples/sampling.py` passes the strings
"PEIKERT" and "KNUTH_YAO", and so samples Knuth-Yao under both names).
"""

from __future__ import annotations

import math

import numpy as np

from openfhe_tpu_torch.utils.prng import get_prng

KNUTH_YAO = 0
PEIKERT = 1
PRECISION = 53
BERNOULLI_FLIPS = 23
MAX_TREE_DEPTH = 64
MAX_LEVELS = 4


class BitGenerator:
    """(reference BitGenerator) centralized random-bit pool."""

    def __init__(self):
        self._sequence = 0
        self._counter = 0

    def generate(self) -> int:
        if self._counter == 0:
            self._sequence = get_prng()()
            self._counter = 32
        bit = (self._sequence >> (self._counter - 1)) & 1
        self._counter -= 1
        return bit


class BaseSampler:
    """(reference BaseSampler) fixed (mean, std) sampler; mean is split
    into an integer part and a fractional center baked into the tables."""

    def __init__(self, mean: float, std: float, bg: BitGenerator,
                 b_type: int = PEIKERT):
        if b_type not in (KNUTH_YAO, PEIKERT):
            raise ValueError(f"b_type {b_type!r}: expected KNUTH_YAO "
                             f"({KNUTH_YAO}) or PEIKERT ({PEIKERT})")
        self.bg = bg
        self.b_type = b_type
        self.b_std = std
        acc = 1e-17
        self.fin = int(math.ceil(std * math.sqrt(-2 * math.log(acc))))
        self.b_mean = math.floor(mean) if mean >= 0 else math.ceil(mean)
        frac = mean - self.b_mean
        if b_type == PEIKERT:
            self._init_peikert(frac)
        else:
            self._init_knuth_yao(frac)

    def random_bit(self) -> int:
        return self.bg.generate()

    # -- Peikert inversion -------------------------------------------------
    def _init_peikert(self, mean: float) -> None:
        xs = np.arange(-self.fin, self.fin + 1, dtype=np.float64)
        probs = np.exp(-(xs - mean) ** 2 / (2 * self.b_std * self.b_std))
        self.m_vals = np.cumsum(probs / probs.sum())

    def _gen_peikert(self) -> int:
        seed = (get_prng()() + 0.5) / 4294967296.0
        idx = int(np.searchsorted(self.m_vals, seed))
        return idx - self.fin + self.b_mean

    # -- Knuth-Yao DDG tree ------------------------------------------------
    def _init_knuth_yao(self, mean: float) -> None:
        fin = self.fin
        self.matrix_size = 2 * fin + 1
        xs = np.arange(-fin, fin + 1, dtype=np.float64)
        probs = np.exp(-(xs - mean) ** 2 / (2 * self.b_std * self.b_std))
        probs = probs / probs.sum()
        prob_matrix = np.zeros(self.matrix_size + 1, np.uint64)
        error = 1.0
        hamming = np.zeros(64, np.int64)
        for i in range(self.matrix_size):
            error -= probs[i]
            prob_matrix[i] = min(int(probs[i] * 2.0 ** 64), 2 ** 64 - 1)
            for j in range(64):
                hamming[j] += (int(prob_matrix[i]) >> (63 - j)) & 1
        prob_matrix[self.matrix_size - 1] = min(
            int(max(error, 0.0) * 2.0 ** 64), 2 ** 64 - 1)
        self._build_ddg(prob_matrix[:self.matrix_size], hamming)

    def _build_ddg(self, prob_matrix, hamming) -> None:
        first = next((i for i in range(64) if hamming[i]), -1)
        self.first_nonzero = first
        end = first
        node_count = 1 << max(first, 0)
        max_nodes = node_count
        done = False
        i = first
        while i < MAX_TREE_DEPTH and not done:
            node_count *= 2
            end += 1
            max_nodes = max(max_nodes, node_count)
            node_count -= int(hamming[i])
            if node_count <= 0:
                done = True
                if node_count < 0:
                    end -= 1
            i += 1
        self.end_index = end
        width = end - first
        self.ddg = np.full((max_nodes, max(width, 1)), -2, np.int64)
        node_count = 1 << max(first, 0)
        for lvl in range(first, end):
            node_count *= 2
            node_count -= int(hamming[lvl])
            self.ddg[:max(node_count, 0), lvl - first] = -1
            e = 0
            for j in range(len(prob_matrix)):
                if e == hamming[lvl]:
                    break
                if (int(prob_matrix[j]) >> (63 - lvl)) & 1:
                    self.ddg[node_count + e, lvl - first] = j
                    e += 1

    def _gen_knuth_yao(self) -> int:
        while True:
            node = 0
            ans = -1
            err = False
            for i in range(MAX_TREE_DEPTH):
                node = node * 2 + self.bg.generate()
                if self.first_nonzero <= i:
                    if i <= self.end_index and node < self.ddg.shape[0] \
                            and i - self.first_nonzero < self.ddg.shape[1]:
                        ans = int(self.ddg[node, i - self.first_nonzero])
                    if ans >= 0:
                        if ans != self.matrix_size - 1:
                            return ans - self.fin + self.b_mean
                        err = True
                    elif ans == -2:
                        err = True
                if err:
                    break

    def generate_integer(self) -> int:
        if self.b_type == PEIKERT:
            return self._gen_peikert()
        return self._gen_knuth_yao()


class SamplerCombiner:
    """(reference SamplerCombiner) x1*s1 + x2*s2."""

    def __init__(self, s1, s2, x1: int, x2: int):
        self.s1, self.s2, self.x1, self.x2 = s1, s2, x1, x2

    def generate_integer(self) -> int:
        return self.x1 * self.s1.generate_integer() \
            + self.x2 * self.s2.generate_integer()


class DiscreteGaussianGeneratorGeneric:
    """(reference DiscreteGaussianGeneratorGeneric) runtime-parameter
    sampling from 2^log_base fixed base samplers."""

    def __init__(self, samplers: list, std: float, log_base: int,
                 n_smooth: float):
        self.base_samplers = samplers
        self.log_base = log_base
        base_variance = std * std
        self.wide_sampler = samplers[0]
        self.wide_variance = base_variance
        for _ in range(1, MAX_LEVELS):
            x1 = int(math.floor(math.sqrt(
                self.wide_variance / (2 * n_smooth * n_smooth))))
            x2 = max(x1 - 1, 1)
            self.wide_sampler = SamplerCombiner(self.wide_sampler,
                                                self.wide_sampler, x1, x2)
            self.wide_variance = (x1 * x1 + x2 * x2) * self.wide_variance
        self.k = int(math.ceil((PRECISION - BERNOULLI_FLIPS) / log_base))
        self.mask = (1 << log_base) - 1
        s, t, var = 1.0, 1.0 / (1 << (2 * log_base)), 1.0
        for _ in range(1, self.k):
            s *= t
            var += s
        self.sampler_variance = var * base_variance

    def generate_integer(self, center: float, std: float) -> int:
        variance = std * std
        x = self.wide_sampler.generate_integer()
        c = center + x * math.sqrt(
            max(variance - self.sampler_variance, 0.0) / self.wide_variance)
        ci = math.floor(c)
        return int(ci) + self._flip_and_round(c - ci)

    def _flip_and_round(self, center: float) -> int:
        c = int(center * (1 << PRECISION))
        base_c = c >> BERNOULLI_FLIPS
        for i in range(BERNOULLI_FLIPS - 1, -1, -1):
            bit = self.base_samplers[0].random_bit()
            cbit = (c >> i) & 1
            if bit > cbit:
                return self._sample_c(base_c)
            if bit < cbit:
                return self._sample_c(base_c + 1)
        return self._sample_c(base_c + 1)

    def _sample_c(self, center: int) -> int:
        c = center
        for _ in range(self.k):
            sample = self.base_samplers[self.mask & c].generate_integer()
            if (self.mask & c) > 0 and c < 0:
                sample -= 1
            c = (c >> self.log_base) + sample \
                if c >= 0 else -((-c) >> self.log_base) + sample
        return c
