"""Unified runtime configuration (port of ``lasp_tpu.config``).

One typed, frozen dataclass: defaults in code, overrides from ``LASP_*``
environment variables, explicit construction for programmatic use. Every
field maps to ``LASP_<FIELDNAME upper>``; unknown ``LASP_*`` variables are
refused, and the pass-through prefixes are JAX's, so the same environment
is accepted or refused by both packages.

What the port reads today: ``flight_rounds`` (the flight ring's depth,
``telemetry.device``) and ``n_actors`` (the default writer universe of a
``Store``). ``fanout`` and ``fused_block`` size the CLI's simulations,
``etf`` selects the bridge's wire codec (:mod:`.bridge.etf`) and
``mesh_state_axis`` waits for multi-device sharding; ``gossip_impl`` keeps
JAX's vocabulary (``auto | xla | pallas``) so validation agrees, and the
port does not read it (its gossip runs the CUDA kernels on the card); the
``bench_*`` knobs serve ``bench.py``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional


@dataclasses.dataclass(frozen=True)
class LaspConfig:
    # -- capacity defaults (the include/lasp.hrl compile-time macro role) --
    #: default per-variable writer universe (Store(n_actors=...));
    #: element/token capacities stay per-declare arguments on purpose —
    #: they size each variable's universe, not the process
    n_actors: int = 16

    # -- gossip / engine ----------------------------------------------------
    #: pull-gossip fan-in for cli simulate / scenario topologies
    fanout: int = 3
    #: rounds per fused dispatch for the engine-scale scenarios and cli
    fused_block: int = 4
    #: headline gossip kernel: auto | xla | pallas
    gossip_impl: str = "auto"

    # -- benchmark knobs (bench.py / cli bench) ------------------------------
    bench_replicas: Optional[int] = None  # None = bench picks per platform
    bench_northstar_replicas: Optional[int] = None
    bench_block: int = 4

    # -- mesh ---------------------------------------------------------------
    #: extent of the tensor-parallel "state" axis in build_mesh
    mesh_state_axis: int = 1

    # -- telemetry ----------------------------------------------------------
    #: flight-recorder ring depth K: the last K rounds of per-round
    #: records each fused window retains on device and drains on its
    #: sync (telemetry/device.py; windows longer than K keep the
    #: suffix and count the lost prefix as overwritten)
    flight_rounds: int = 64

    # -- bridge -------------------------------------------------------------
    #: wire codec selection: auto (native .so when present AND it passes
    #: the byte-conformance self-check, else python) | python (forced)
    etf: str = "auto"

    @classmethod
    def field_env_name(cls, field_name: str) -> str:
        return f"LASP_{field_name.upper()}"

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "LaspConfig":
        """Defaults overridden by ``LASP_*`` env vars. Unknown ``LASP_*``
        names raise (except the driver/runner-owned ``LASP_BENCH_*`` and
        ``LASP_DRYRUN_*`` timeout knobs, which bench.py/__graft_entry__
        own directly)."""
        env = os.environ if env is None else env
        fields = {f.name: f for f in dataclasses.fields(cls)}
        by_env = {cls.field_env_name(n): n for n in fields}
        overrides = {}
        passthrough_prefixes = (
            "LASP_BENCH_PROBE",
            "LASP_BENCH_TPU_TIMEOUT",
            "LASP_BENCH_CPU_TIMEOUT",
            "LASP_BENCH_TOTAL_BUDGET",
            "LASP_BENCH_CHILD_BUDGET",
            "LASP_DRYRUN",
            "LASP_STATEM",  # test-suite soak depth (tests/lattice)
            "LASP_TELEMETRY",  # telemetry sinks (JSONL path etc.),
            # read directly by lasp_tpu.telemetry.spans

            "LASP_WATCH",  # tools/tpu_capture.py watcher knobs
            "LASP_ONESHOT",  # tools/tpu_oneshot.py capture knobs
        )
        for key, raw in env.items():
            if not key.startswith("LASP_"):
                continue
            if any(key.startswith(p) for p in passthrough_prefixes):
                continue
            if key not in by_env:
                known = ", ".join(sorted(by_env))
                raise ValueError(
                    f"unknown config variable {key} (known: {known})"
                )
            name = by_env[key]
            ftype = fields[name].type
            if ftype in ("int", "Optional[int]", int):
                overrides[name] = int(raw)
            else:
                overrides[name] = raw
        return cls(**overrides)

    def validate(self) -> "LaspConfig":
        if self.gossip_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"gossip_impl: {self.gossip_impl!r}")
        if self.etf not in ("auto", "python"):
            raise ValueError(f"etf: {self.etf!r} (auto | python)")
        for name in ("n_actors", "fanout", "fused_block", "mesh_state_axis",
                     "bench_block", "flight_rounds"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        return self


def get_config() -> LaspConfig:
    """The process-wide config, resolved from the environment once."""
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = LaspConfig.from_env().validate()
    return _CONFIG


def set_config(cfg: LaspConfig) -> LaspConfig:
    """Install ``cfg`` (validated) as the process-wide config and notify
    already-materialized dependents: the ETF wire codec re-runs its
    selection (``cfg.etf``) once it has made one, so ``LaspConfig(etf=
    "python")`` takes effect after the first frame too."""
    global _CONFIG
    _CONFIG = cfg.validate()
    import sys

    etf_mod = sys.modules.get("lasp_tpu_torch.bridge.etf")
    if etf_mod is not None and etf_mod.IMPL is not None:
        etf_mod.reselect()
    return _CONFIG


_CONFIG: Optional[LaspConfig] = None
