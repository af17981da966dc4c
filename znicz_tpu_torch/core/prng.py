"""Deterministic seeded PRNG — the port of ``znicz_tpu/core/prng.py``
(rebuild of veles/prng/random_generator.py).

Every stochastic decision (weight init, dataset shuffles, device-side
masks) goes through a process-global registry of named seeded streams,
``prng.get(key)``.  The host half is the reference's, verbatim: each
named stream is a ``numpy.random.Generator`` (PCG64) seeded by the same
``_derive`` rule, so one seed gives the port and the JAX package
bit-identical initial weights and shuffles.  The device half differs:
``key()`` returns a ``torch.Generator`` on the device, seeded from
(seed, counter), in place of a jax key — the two frameworks draw
different device bits from one seed, so tests feed both sides numpy
noise where they must agree.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


class RandomGenerator:
    """One named deterministic stream (reference: RandomGenerator)."""

    def __init__(self, name: str, seed: int | None = None) -> None:
        self.name = name
        self.seed(seed if seed is not None else 0xDEADBEEF)

    # -- lifecycle ----------------------------------------------------------
    def seed(self, seed: int) -> None:
        self._seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        self._np = np.random.Generator(np.random.PCG64(self._seed))
        self._key_counter = 0

    @property
    def initial_seed(self) -> int:
        return self._seed

    # -- host-side draws (numpy, stateful-sequential) -----------------------
    def uniform(self, low: float, high: float, size=None, dtype=np.float32):
        return self._np.uniform(low, high, size).astype(dtype, copy=False)

    def normal(self, loc: float = 0.0, scale: float = 1.0, size=None,
               dtype=np.float32):
        return self._np.normal(loc, scale, size).astype(dtype, copy=False)

    def randint(self, low: int, high: int, size=None):
        return self._np.integers(low, high, size)

    def shuffle(self, arr) -> None:
        self._np.shuffle(arr)

    def permutation(self, n: int):
        return self._np.permutation(n)

    def fill(self, arr: np.ndarray, low: float = -1.0, high: float = 1.0) -> None:
        """In-place uniform fill, the reference's weight-init primitive."""
        arr[...] = self._np.uniform(low, high, arr.shape).astype(arr.dtype)

    # -- device-side draws (counter-based torch generators) -----------------
    def key(self, device="cuda") -> torch.Generator:
        """Mint a fresh ``torch.Generator`` on ``device``, deterministic
        per (seed, counter)."""
        self._key_counter += 1
        gen = torch.Generator(device=device)
        gen.manual_seed(int(np.random.SeedSequence(
            (self._seed, self._key_counter)).generate_state(1, np.uint64)[0]))
        return gen

    # -- snapshot support ---------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "seed": self._seed,
            "np_state": self._np.bit_generator.state,
            "key_counter": self._key_counter,
        }

    def load_state_dict(self, state: dict) -> None:
        self._seed = state["seed"]
        self._np = np.random.Generator(np.random.PCG64())
        self._np.bit_generator.state = state["np_state"]
        self._key_counter = state["key_counter"]


_generators: dict[str, RandomGenerator] = {}
_session_seed: int = 0xDEADBEEF


def _derive(seed: int, name: str) -> int:
    """Stable per-name seed derivation (crc32, not builtin hash — the latter
    is randomized per process and would break cross-process determinism)."""
    return seed if name == "default" else seed ^ zlib.crc32(name.encode())


def get(key: str = "default") -> RandomGenerator:
    """The reference's ``prng.get()`` registry accessor.  Streams created
    after ``seed_all`` derive from the session seed, so creation order
    relative to seeding does not matter."""
    gen = _generators.get(key)
    if gen is None:
        gen = _generators[key] = RandomGenerator(key, _derive(_session_seed, key))
    return gen


def seed_all(seed: int) -> None:
    """Set the session seed and reseed all streams (existing and future)
    deterministically — the CLI ``--random-seed`` entry point."""
    global _session_seed
    _session_seed = int(seed)
    for name, gen in _generators.items():
        gen.seed(_derive(_session_seed, name))
    get("default")


def state_dict() -> dict:
    return {name: gen.state_dict() for name, gen in _generators.items()}


def load_state_dict(state: dict) -> None:
    for name, gen_state in state.items():
        get(name).load_state_dict(gen_state)
