"""Generator — composable random-data generation (a monad over an RNG).

Reference parity: client/mock Generator (client/mock/.../Generator.kt:1-225)
+ Generators.kt: pure/map/flat_map/combine composition, choice/frequency,
collection generators — the substrate under GeneratedLedger and the loadtest
scenarios. A copy of corda_tpu.testing.generator: the same seed draws the
same values.
"""
from __future__ import annotations

import random
from typing import Any, Callable


class Generator:
    def __init__(self, fn: Callable[[random.Random], Any]):
        self._fn = fn

    def generate(self, rng: random.Random):
        return self._fn(rng)

    # -- composition ---------------------------------------------------------
    @staticmethod
    def pure(value) -> "Generator":
        return Generator(lambda rng: value)

    def map(self, f: Callable) -> "Generator":
        return Generator(lambda rng: f(self._fn(rng)))

    def flat_map(self, f: Callable[[Any], "Generator"]) -> "Generator":
        return Generator(lambda rng: f(self._fn(rng)).generate(rng))

    @staticmethod
    def combine(*gens: "Generator", with_fn: Callable = lambda *a: a
                ) -> "Generator":
        return Generator(lambda rng: with_fn(*[g.generate(rng) for g in gens]))

    # -- primitives ----------------------------------------------------------
    @staticmethod
    def int_range(lo: int, hi: int) -> "Generator":
        return Generator(lambda rng: rng.randint(lo, hi))

    @staticmethod
    def bytes_of(n: int) -> "Generator":
        return Generator(lambda rng: rng.randbytes(n))

    @staticmethod
    def choice(items) -> "Generator":
        items = list(items)
        return Generator(lambda rng: rng.choice(items))

    @staticmethod
    def frequency(*weighted: tuple[float, "Generator"]) -> "Generator":
        weights = [w for w, _ in weighted]
        gens = [g for _, g in weighted]

        def gen(rng):
            return rng.choices(gens, weights=weights, k=1)[0].generate(rng)

        return Generator(gen)

    def list_of(self, size_gen: "Generator") -> "Generator":
        return Generator(lambda rng: [self._fn(rng) for _ in
                                      range(size_gen.generate(rng))])

    @staticmethod
    def shuffled(items) -> "Generator":
        def gen(rng):
            out = list(items)
            rng.shuffle(out)
            return out
        return Generator(gen)

    @staticmethod
    def poisson_size(mean: float, cap: int = 50) -> "Generator":
        """Poisson-ish sized collections (GeneratedLedger's component lists)."""
        def gen(rng):
            n, p = 0, rng.random()
            import math
            threshold = math.exp(-mean)
            while p > threshold and n < cap:
                p *= rng.random()
                n += 1
            return n
        return Generator(gen)
