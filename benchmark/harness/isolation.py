"""The run's isolation: the process that prints a result holds none of
the JAX package, JAX itself or Flax, compared by whole top-level module
names (``lasp_tpu_torch`` is not ``lasp_tpu``)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "lasp_tpu"})


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
