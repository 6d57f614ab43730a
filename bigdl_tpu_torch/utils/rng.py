"""Seeded random generator for host-side shuffling (counterpart of
``bigdl_tpu/utils/rng.py``, a copy).

Rebuild of the reference's Mersenne-Twister ``RandomGenerator``
(utils/RandomGenerator.scala:56) on numpy's MT19937, so one seed gives
the JAX package's stream: the same epoch shuffles.  The JAX package's
``next_jax_key`` becomes :func:`next_step_seed`, which draws from the
stream exactly as it does.
"""
from __future__ import annotations

import threading

import numpy as np


class RandomGenerator:
    """Per-instance seeded generator (uniform/normal/bernoulli/shuffle)."""

    def __init__(self, seed: int = 1):
        self._seed = seed
        self._rng = np.random.Generator(np.random.MT19937(seed))

    def set_seed(self, seed: int):
        self._seed = seed
        self._rng = np.random.Generator(np.random.MT19937(seed))
        return self

    # camelCase alias for API parity with the reference
    setSeed = set_seed

    def get_seed(self) -> int:
        return self._seed

    # -- checkpointable state (the determinism contract) ---------------
    def state_dict(self) -> dict:
        """Total generator state: the seed plus the MT19937
        bit-generator state (position in the stream included), so a
        restored generator continues the exact bit sequence — the host
        RNG's half of bitwise-faithful resume (docs/determinism.md)."""
        return {"seed": self._seed,
                "bit_generator": self._rng.bit_generator.state}

    def load_state_dict(self, state: dict) -> "RandomGenerator":
        self._seed = state["seed"]
        self._rng = np.random.Generator(np.random.MT19937(self._seed))
        self._rng.bit_generator.state = state["bit_generator"]
        return self

    def clone(self) -> "RandomGenerator":
        c = RandomGenerator(self._seed)
        c._rng.bit_generator.state = self._rng.bit_generator.state
        return c

    def uniform(self, a=0.0, b=1.0, size=None):
        return self._rng.uniform(a, b, size=size)

    def normal(self, mean=0.0, stdv=1.0, size=None):
        return self._rng.normal(mean, stdv, size=size)

    def bernoulli(self, p=0.5, size=None):
        return (self._rng.random(size=size) < p).astype(np.float32)

    def exponential(self, lam=1.0, size=None):
        return self._rng.exponential(1.0 / lam, size=size)

    def random_int(self, low, high, size=None):
        return self._rng.integers(low, high, size=size)

    def permutation(self, n: int):
        return self._rng.permutation(n)

    def shuffle(self, arr):
        """In-place Fisher-Yates shuffle (reference RandomGenerator.scala:35)."""
        self._rng.shuffle(arr)
        return arr


_local = threading.local()


def RNG() -> RandomGenerator:
    """Thread-local default generator (reference ``RandomGenerator.RNG``)."""
    if not hasattr(_local, "rng"):
        _local.rng = RandomGenerator(1)
    return _local.rng


# the last seed EXPLICITLY requested through set_global_seed (None until
# then): derived streams (synthetic datasets, per-dataset shard
# shufflers) key off it so one call re-seeds every stream, while code
# that never opts in keeps its historical fixed seeds
_explicit_seed = None


def set_global_seed(seed: int):
    global _explicit_seed
    _explicit_seed = int(seed)
    RNG().set_seed(seed)


def derive_seed(fallback: int) -> int:
    """Seed for a named sub-stream: the historical ``fallback`` when no
    global seed was ever set (exact legacy behavior), otherwise a
    deterministic mix of the global seed and the stream id — so
    ``set_global_seed`` actually governs every generator in the tree
    without collapsing distinct streams onto one sequence."""
    if _explicit_seed is None:
        return int(fallback)
    return (_explicit_seed * 0x9E3779B1 + int(fallback)) % (2**31 - 1)


def np_stream(fallback: int) -> "np.random.RandomState":
    """A ``RandomState`` for a derived sub-stream (see
    :func:`derive_seed`) — the routing point for the synthetic dataset
    generators in ``dataset/datasets.py``."""
    return np.random.RandomState(derive_seed(fallback))


def next_step_seed() -> int:
    """The per-step seed the training loop draws from the host
    generator, one draw per step, as the JAX package draws its per-step
    ``jax.random`` key: the host stream, and so every later epoch
    shuffle, stays the JAX package's."""
    return int(RNG().random_int(0, 2**31 - 1))
