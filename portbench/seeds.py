"""Seeds for each use, derived from a run's `--seed` (any whole number)."""

from __future__ import annotations

import zlib

import numpy as np


def _entropy(seed: int, use: str) -> list:
    return [int(seed) % (1 << 64), zlib.crc32(use.encode())]


def rng(seed: int, use: str) -> np.random.Generator:
    """A numpy generator for one use of a run's seed."""
    return np.random.default_rng(np.random.SeedSequence(_entropy(seed, use)))


def torch_seed(seed: int, use: str) -> int:
    """A 63-bit seed for a `torch.Generator`, for one use of a run's seed."""
    a, b = np.random.SeedSequence(_entropy(seed, use)).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)
