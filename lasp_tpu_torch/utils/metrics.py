"""Host timing (the ``Timer`` of ``lasp_tpu.utils.metrics``; the runtime's
``StepTrace`` and the ``jax.profiler`` block tracer are not carried)."""

from __future__ import annotations

import time


class Timer:
    __slots__ = ("t0", "elapsed")

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
