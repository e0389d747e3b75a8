"""The clock of the window, copied from ``lasp_tpu_torch.bench_scenarios``
(``_timed``) so that a change to the port cannot move it.

A region of device work is timed on the host clock between two
synchronizations of the device: the host's own work inside the region (the
frontier scheduler, the write path's encoders) is part of what a user
waits for, so CUDA events (``bench_scenarios._Clock``), which see only the
device's stream, would leave it out."""

from __future__ import annotations

import time

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(device: torch.device, fn):
    """``(fn(), seconds)``: the region opens and closes on a synchronized
    device."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


class Parts:
    """Seconds of each named part of the set-up, each closed by a
    synchronize of the device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        """Close the part that ran since the last mark."""
        sync(self.device)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self._t
        self._t = now
