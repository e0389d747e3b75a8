"""Independent streams from one ``--seed``, which may be any whole number,
larger too than 32 signed bits hold."""

from __future__ import annotations

import zlib

import numpy as np


def sub(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of ``seed``."""
    ss = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), zlib.crc32(tag.encode())])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub(seed, tag))
