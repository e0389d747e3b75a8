"""Device capability registry (port of ``lasp_tpu.telemetry.capability``,
without the ``PROBE_*`` report schema, which serves ``bench.py``'s TPU
probe).

The one table of peak HBM bandwidth by device kind: every roofline
denominator of the port (the kernel cost ledger, ``chip_smoke.py``'s
bounds) reads it. The kind is ``torch.cuda.get_device_name()``; a process
without CUDA reports ``peak_GBps`` None (the port's kernels run on the
card, so no host-memory figure stands in for it). ``measure_host_bandwidth``
stays for callers that want the host's copy rate on its own.
"""

from __future__ import annotations

import time

from . import registry as _registry

#: single-card peak HBM bandwidth, GB/s, by device-kind substring (NVIDIA
#: data sheets) — first match wins, so more specific kinds sort first.
#: JAX's TPU rows follow, for parity of lookups.
PEAK_HBM_GBPS = (
    ("h200", 4800.0),
    ("h100 pcie", 2000.0),
    ("h100 nvl", 3900.0),
    ("h100", 3350.0),  # H100 SXM (HBM3)
    ("v6e", 1638.0),
    ("v6", 1638.0),
    ("v5p", 2765.0),
    ("v5e", 819.0),
    ("v5 lite", 819.0),
    ("v4", 1228.0),
    ("v3", 900.0),
    ("v2", 700.0),
)


def peak_gbps_for_kind(device_kind: str) -> "float | None":
    """Pinned peak HBM GB/s for a device-kind string, or None when the kind
    is not in the registry (an unknown card reports an honest null, never a
    guessed denominator)."""
    k = str(device_kind).lower()
    for sub, gbps in PEAK_HBM_GBPS:
        if sub in k:
            return gbps
    return None


_host_bw: dict = {}


def measure_host_bandwidth(size_mb: int = 128, reps: int = 3) -> float:
    """One-shot measured host-memory bandwidth, GB/s (cached per
    ``(size_mb, reps)``): best-of-``reps`` large ``np.copyto`` passes, the
    read+write convention (2 bytes moved per byte copied)."""
    key = (int(size_mb), int(reps))
    cached = _host_bw.get(key)
    if cached is not None:
        return cached
    import numpy as np

    n = max(1, int(size_mb)) * (1 << 20) // 8
    src = np.ones(n, dtype=np.float64)
    dst = np.empty_like(src)
    best = float("inf")
    for i in range(reps + 1):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        dt = time.perf_counter() - t0
        if i:  # first pass warms the pages, not the clock
            best = min(best, dt)
    _host_bw[key] = round(2 * n * 8 / best / 1e9, 2)
    return _host_bw[key]


_capability: "dict | None" = None
#: registry generation the capability gauge was last emitted into: a cache
#: hit re-emits into a new generation (``telemetry.reset()``)
_capability_gauge_gen: "int | None" = None


def _emit_capability_gauge(cap: dict) -> None:
    global _capability_gauge_gen
    _registry.gauge(
        "capability_peak_GBps",
        help="roofline denominator: peak HBM GB/s (pinned by device "
             "kind) or measured host-memory bandwidth on CPU",
        device_kind=cap["device_kind"],
        source=cap["source"],
    ).set(cap["peak_GBps"] if cap["peak_GBps"] is not None else 0)
    _capability_gauge_gen = _registry.generation()


def cached_peak_gbps() -> "float | None":
    """The cached record's roofline denominator without resolving one — the
    hot-path accessor (the ledger's sampled gauge refresh)."""
    if _capability is None:
        return None
    return _capability["peak_GBps"]


def device_capability(refresh: bool = False) -> dict:
    """The attached card's capability record (cached): ``{"platform",
    "device_kind", "peak_GBps", "source"}``, ``source`` ``"pinned"`` (a
    registry hit) or ``"unknown"`` (a kind the registry does not know, or
    no card: ``peak_GBps`` None)."""
    global _capability
    if _capability is not None and not refresh:
        if _capability_gauge_gen != _registry.generation():
            _emit_capability_gauge(_capability)
        return _capability
    import torch

    platform, kind = "cpu", "cpu"
    if torch.cuda.is_available():
        platform, kind = "gpu", str(torch.cuda.get_device_name(0))
    peak = peak_gbps_for_kind(kind) if platform != "cpu" else None
    cap = {
        "platform": platform,
        "device_kind": kind,
        "peak_GBps": peak,
        "source": "pinned" if peak is not None else "unknown",
    }
    _emit_capability_gauge(cap)
    _capability = cap
    return cap
