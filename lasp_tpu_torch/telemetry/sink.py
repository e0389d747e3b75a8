"""Shared append-only JSONL sink: the ONE file writer behind the span
ring and the causal event log (a copy of ``lasp_tpu.telemetry.sink``).

Both rings can be fed from many threads at once (the bridge's
per-connection threads, the mesh's batch-dispatch callers, a watch
callback firing under ``Store._write``); a naive per-module
open-and-write would interleave partial lines. This class owns the
whole serialize-and-write critical section under one lock — a line
either lands complete or not at all — and keeps the sink-failure
contract every telemetry surface shares: a broken file disables the
sink LOUDLY ONCE (stderr) instead of failing every traced operation
from then on.

Env-var default semantics (mirrors the original span sink): the first
append resolves the configured env var exactly once; an explicit
:meth:`configure` beats the env var, and ``configure("")`` closes and
disables the sink.
"""

from __future__ import annotations

import json
import os
import sys
import threading


class JsonlSink:
    """Thread-safe append-only JSONL file writer (one JSON object per
    line). All state transitions — env resolution, lazy open, write,
    failure-disable — happen under the instance lock."""

    def __init__(self, env_var: "str | None" = None):
        self._env_var = env_var
        self._lock = threading.Lock()
        self._path: "str | None" = None
        self._file = None
        self._checked = env_var is None  # no env var: nothing to resolve
        self.lines_written = 0

    def configure(self, path: "str | None") -> None:
        """``path=None`` keeps the current file; ``""`` closes and
        disables; anything else re-targets the sink."""
        if path is None:
            return
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
            self._file = None
            self._path = path or None
            self._checked = True  # explicit configure beats the env var

    @property
    def path(self) -> "str | None":
        with self._lock:
            return self._path

    def append(self, rec: dict) -> None:
        """Serialize + write one record as a single line; never raises
        (a broken sink must not break the traced operation)."""
        with self._lock:
            if not self._checked:
                # first record decides the env-var default exactly once
                self._path = os.environ.get(self._env_var) or None
                self._checked = True
            if self._path is None:
                return
            try:
                # default=repr absorbs unserializable VALUES; a circular
                # container still raises — that is one bad record, so it
                # is dropped loudly without disabling the sink
                line = json.dumps(rec, default=repr) + "\n"
            except (TypeError, ValueError) as exc:
                print(
                    f"lasp_tpu_torch.telemetry: dropped unserializable record "
                    f"({exc})",
                    file=sys.stderr,
                )
                return
            try:
                if self._file is None:
                    self._file = open(self._path, "a", buffering=1)
                self._file.write(line)
                self.lines_written += 1
            except OSError as exc:
                # disable loudly ONCE rather than failing every record
                print(
                    f"lasp_tpu_torch.telemetry: JSONL sink {self._path!r} failed "
                    f"({exc}); file logging disabled",
                    file=sys.stderr,
                )
                self._path = None
                self._file = None
