"""Step-level metrics and tracing (port of ``lasp_tpu.utils.metrics``).

- :class:`StepTrace` — the per-runtime round record (``rt.trace``): every
  ``record_round`` appends to the local round list (``summary()`` and the
  CLI read it) and mirrors a dispatch count and its timing into the
  process-global registry (``step_dispatches_total`` /
  ``step_dispatch_seconds``).
- :func:`profile` — the ``torch.profiler`` block tracer, writing a Chrome
  trace into the directory it is given (re-exported by
  ``lasp_tpu_torch.telemetry``).
- :class:`Timer` — host wall time of a block.
"""

from __future__ import annotations

import contextlib
import os
import time


class StepTrace:
    """Append-only record of bulk-synchronous rounds: residuals, timings,
    and arbitrary counters. One per runtime; cheap enough to always keep
    on. The local record is authoritative for ``summary()``; each
    ``record_round`` also mirrors into the telemetry registry (one
    *dispatch* per call — fused blocks count their rounds separately via
    the runtime's ``gossip_rounds_total``)."""

    def __init__(self):
        self.rounds: list[dict] = []
        self.counters: dict[str, int] = {}
        self._tel: "tuple | None" = None  # (generation, counter, histogram)

    def record_round(self, residual: int, seconds: float, **extra) -> None:
        self.rounds.append({"residual": residual, "seconds": seconds, **extra})
        # lazy import: the telemetry package re-exports profile from here
        from ..telemetry import registry as _reg

        if not _reg.enabled():
            return
        # instruments cached per registry generation: this runs per step
        # dispatch, and a name + label lookup each time is measurable
        # against small steps (the overhead guard's workload)
        gen = _reg.generation()
        if self._tel is None or self._tel[0] != gen:
            reg = _reg.get_registry()
            self._tel = (
                gen,
                reg.counter(
                    "step_dispatches_total",
                    help="compiled step/block dispatches issued by runtimes",
                ),
                reg.histogram(
                    "step_dispatch_seconds",
                    help="wall time per compiled step/block dispatch",
                ),
            )
        self._tel[1].inc()
        self._tel[2].observe(seconds)

    def bump(self, name: str, by: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + by

    @property
    def total_rounds(self) -> int:
        return len(self.rounds)

    @property
    def total_seconds(self) -> float:
        return sum(r["seconds"] for r in self.rounds)

    def summary(self) -> dict:
        residuals = [r["residual"] for r in self.rounds]
        return {
            "rounds": len(self.rounds),
            "seconds": round(self.total_seconds, 6),
            "residual_path": residuals,
            **self.counters,
        }


@contextlib.contextmanager
def profile(log_dir: str):
    """``torch.profiler`` trace around a block, written as a Chrome trace
    (``trace.json``) into ``log_dir`` (open it in Perfetto). CUDA activity
    is recorded when a card is present.

    Exception-safe on both edges, as JAX's: a failure to start propagates
    without a stop, and a failure to stop while the body is already raising
    is suppressed so the body's error survives."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()  # a failure here has nothing to stop
    try:
        yield
    except BaseException:
        try:
            prof.__exit__(None, None, None)
        except Exception:
            pass  # the body's exception is the one that must propagate
        raise
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    __slots__ = ("t0", "elapsed")

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
