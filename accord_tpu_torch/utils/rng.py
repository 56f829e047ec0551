"""Forkable deterministic random source -- the root of simulation determinism.

Mirrors the role of the reference's RandomSource (utils/RandomSource.java):
every component that needs randomness receives a fork of the top-level seeded
source, so a 64-bit seed fully determines a whole-cluster simulation run.
"""
from __future__ import annotations

import math
import random
from typing import Optional, Sequence, TypeVar

T = TypeVar("T")


class RandomSource:
    __slots__ = ("_rng",)

    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def fork(self) -> "RandomSource":
        return RandomSource(self.next_long())

    def next_long(self) -> int:
        return self._rng.getrandbits(64)

    def next_int(self, bound: int) -> int:
        """Uniform in [0, bound)."""
        return self._rng.randrange(bound)

    def next_int_between(self, lo: int, hi: int) -> int:
        """Uniform in [lo, hi)."""
        return self._rng.randrange(lo, hi)

    def next_float(self) -> float:
        return self._rng.random()

    def next_bool(self) -> bool:
        return self._rng.random() < 0.5

    def decide(self, probability: float) -> bool:
        return self._rng.random() < probability

    def pick(self, items: Sequence[T]) -> T:
        return items[self._rng.randrange(len(items))]

    def pick_weighted(self, items: Sequence[T], weights: Sequence[float]) -> T:
        return self._rng.choices(items, weights=weights, k=1)[0]

    def shuffle(self, items: list) -> list:
        self._rng.shuffle(items)
        return items

    def sample(self, items: Sequence[T], k: int) -> list:
        return self._rng.sample(list(items), k)

    def zipf(self, n: int, theta: float = 0.99) -> int:
        """Zipfian-distributed int in [0, n) (hot head), via inverse CDF on a
        truncated harmonic series. Used by workload generators (BASELINE.md
        rw-register config)."""
        # Precomputing the harmonic sum per call is O(n); acceptable for test
        # generators, not on any protocol path.
        h = 0.0
        target = self._rng.random()
        total = sum(1.0 / math.pow(i + 1, theta) for i in range(n))
        for i in range(n):
            h += 1.0 / math.pow(i + 1, theta) / total
            if h >= target:
                return i
        return n - 1

    def exponential_ms(self, mean: float) -> float:
        return self._rng.expovariate(1.0 / mean) if mean > 0 else 0.0

    def uniform_float(self, lo: float, hi: float) -> float:
        return self._rng.uniform(lo, hi)
