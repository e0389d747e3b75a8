"""Telemetry overhead guard: what the always-on registry / span / ledger /
flight layer costs per gossip step, as a fraction of the step itself (port
of ``lasp_tpu.telemetry.overhead``; the report has JAX's keys).

Methodology (JAX's): differential wall-clocking of whole steps drowns in
scheduler noise, so the two factors are measured apart, each in its robust
regime:

1. **numerator** — the exact emission path (a span plus
   ``ReplicatedRuntime._emit_step_telemetry``, ``_emit_frontier_telemetry``,
   ``_drain_flight``, a ledger record) timed in a tight loop, enabled minus
   disabled;
2. **denominator** — the step itself, the minimum over repeated timed
   steps with telemetry off (every timed step ends on a host read of its
   result, so the card's work is inside the clock).

``overhead_frac = emission_cost / step_seconds``. The emission does no
device work apart from the flight ring's writes, which the ``flight`` arm
prices on the device (a window's ring writes timed with and without).
JAX's budget is 5% an arm; the port measures it on the card
(``chip_smoke.py``), the CPU tests check the report's structure only.
"""

from __future__ import annotations

import time

import numpy as np

from . import events as _events
from . import registry as _registry
from . import roofline as _roofline
from .spans import span


def measure_overhead(
    n_replicas: int = 1024, step_samples: int = 30,
    emission_samples: int = 3000, device=None,
) -> dict:
    """Per-step telemetry cost against step cost on small gossip
    populations, on ``device`` (default CUDA); see the module docstring.
    Runs inside a SCRATCH registry so the synthetic emissions never
    pollute live metrics. The ``set_enabled(False)`` windows are
    process-global while they last: run this from a measurement context,
    not a serving one."""
    from ..device import resolve_device

    dev = resolve_device(device)
    with _registry.scratch_registry():
        return _measure(n_replicas, step_samples, emission_samples, dev)


def _measure(n_replicas: int, step_samples: int, emission_samples: int,
             dev) -> dict:
    from ..dataflow import Graph
    from ..mesh import ReplicatedRuntime
    from ..mesh.topology import ring
    from ..store import Store

    prev = _registry.enabled()
    store = Store(n_actors=8, device=dev)
    v = store.declare(type="lasp_orset", n_elems=64)
    rt = ReplicatedRuntime(store, Graph(store), n_replicas, ring(n_replicas, 2),
                           device=dev)
    rt.update_batch(
        v, [(r % n_replicas, ("add", f"x{r}"), f"w{r}") for r in range(8)]
    )
    rt.step()  # first dispatch outside the clock

    res_vec = np.zeros((len(rt.var_ids),), dtype=np.int32)

    def emission_pass(flag: bool) -> float:
        _registry.set_enabled(flag)
        try:
            t0 = time.perf_counter()
            for _ in range(emission_samples):
                with span("gossip.round"):
                    pass
                rt._emit_step_telemetry(res_vec, 0, 1e-6)
            return (time.perf_counter() - t0) / emission_samples
        finally:
            _registry.set_enabled(prev)

    per_step_cost = max(0.0, emission_pass(True) - emission_pass(False))

    def event_pass(flag: bool) -> float:
        _registry.set_enabled(flag)
        try:
            t0 = time.perf_counter()
            for _ in range(emission_samples):
                _events.emit("delivery", residual=0, seconds=0.0)
            return (time.perf_counter() - t0) / emission_samples
        finally:
            _registry.set_enabled(prev)

    event_cost = max(0.0, event_pass(True) - event_pass(False))

    _registry.set_enabled(False)
    try:
        step_s = min(_timed(rt.step) for _ in range(step_samples))
    finally:
        _registry.set_enabled(prev)

    overhead = per_step_cost / step_s if step_s > 0 else 0.0
    few = max(emission_samples // 3, 200)
    frontier = _measure_frontier(step_samples, few, dev)
    ledger = _measure_ledger(few, step_s, frontier["round_seconds"],
                             frontier["dispatches_per_round"])
    dataflow = _measure_dataflow(step_samples, few, dev)
    aae = _measure_aae(step_samples, few, dev)
    flight = _measure_flight(step_samples, few, dev)
    return {
        "frontier": frontier,
        "ledger": ledger,
        "dataflow": dataflow,
        "aae": aae,
        "flight": flight,
        "event_emit_cost_s": round(event_cost, 9),
        "event_log": {k: _events.stats()[k] for k in ("ring_size", "deep")},
        "telemetry_cost_per_step_s": round(per_step_cost, 9),
        "step_seconds": round(step_s, 6),
        "telemetry_on_s": round(step_s + per_step_cost, 6),
        "telemetry_off_s": round(step_s, 6),
        "overhead_frac": round(overhead, 4),
        "n_replicas": n_replicas,
        "step_samples": step_samples,
        "emission_samples": emission_samples,
    }


def _frontier_runtime(dev, n_replicas: int, n_vars: int, n_elems: int, seed: int):
    from ..dataflow import Graph
    from ..mesh import ReplicatedRuntime
    from ..mesh.topology import random_regular
    from ..store import Store

    store = Store(n_actors=4, device=dev)
    ids = [store.declare(id=f"v{i}", type="lasp_gset", n_elems=n_elems)
           for i in range(n_vars)]
    rt = ReplicatedRuntime(store, Graph(store), n_replicas,
                           random_regular(n_replicas, 3, seed=seed), device=dev)
    for i, v in enumerate(ids):
        rt.update_batch(v, [(i % n_replicas, ("add", "x"), f"a{i}")])
    rt.frontier_step()  # warm the kernels and the instruments

    def one_active_round():
        # re-dirty one row per var: a converged store's frontier round
        # is a skip-everything no-op, a dishonestly small denominator
        for i, vid in enumerate(ids):
            rt._mark_dirty_rows(vid, [i % n_replicas])
        rt.frontier_step()

    return rt, ids, one_active_round


def _measure_frontier(step_samples: int, emission_samples: int, dev,
                      n_replicas: int = 256, n_vars: int = 48) -> dict:
    """Grouped-dispatch arm: the planned frontier round's emission
    (``_emit_frontier_telemetry``, per-var gauges over many variables) timed
    against the planned frontier round itself."""
    prev = _registry.enabled()
    rt, _ids, one_active_round = _frontier_runtime(dev, n_replicas, n_vars, 8, 5)
    hot = max(2, n_vars // 8)
    quiet = [0] * (len(rt.var_ids) - hot)
    vecs = ([1] * hot + quiet, [2] * hot + quiet)
    dispatches = max(len(rt._ensure_plan().groups), 1)

    def emission_pass(flag: bool) -> float:
        _registry.set_enabled(flag)
        try:
            t0 = time.perf_counter()
            for k in range(emission_samples):
                with span("gossip.plan_round"):
                    pass
                rt._emit_frontier_telemetry(vecs[k & 1], hot, hot, 0, 0, 1e-6,
                                            dispatches=dispatches)
            return (time.perf_counter() - t0) / emission_samples
        finally:
            _registry.set_enabled(prev)

    cost = max(0.0, emission_pass(True) - emission_pass(False))
    _registry.set_enabled(False)
    try:
        round_s = min(_timed(one_active_round) for _ in range(step_samples))
    finally:
        _registry.set_enabled(prev)
    return {
        "emission_cost_per_round_s": round(cost, 9),
        "round_seconds": round(round_s, 6),
        "overhead_frac": round(cost / round_s if round_s > 0 else 0.0, 4),
        "n_vars": n_vars,
        "n_replicas": n_replicas,
        "dispatches_per_round": dispatches,
    }


def _measure_dataflow(step_samples: int, emission_samples: int, dev,
                      depth: int = 6) -> dict:
    """Fused-propagate arm, JAX's: one ``Graph.propagate`` in fused mode
    against its emission path — the ``dataflow.propagate`` span,
    ``Graph._emit_propagate_telemetry`` (counters, per-kind accounting, the
    ``propagate`` event with its per-dst changed counts) on a stats dict
    shaped like a real run's, and the propagate's one ``dataflow_fused``
    ledger record — over an OR-Set filter chain whose every timed propagate
    runs a real (depth+1)-sweep fixed point."""
    from ..dataflow import Graph
    from ..store import Store

    prev = _registry.enabled()
    store = Store(n_actors=2, device=dev)
    g = Graph(store)
    src = store.declare(id="src", type="lasp_orset", n_elems=4, n_actors=2,
                        tokens_per_actor=4 * step_samples + 16)
    cur = src
    for i in range(depth):
        cur = g.filter(cur, lambda t: True, dst=f"f{i}")
    store.update(src, ("add", "x"), "w")
    g.propagate()  # build and warm the fused entry

    stats = {
        "rounds": depth, "executed": depth + 1,
        "runs": [depth + 1] * len(g.edges), "fused": True,
        "changed_by_dst": {f"f{i}": depth - i for i in range(depth)},
    }
    ledger = _roofline.get_ledger()
    rec = dict(n_replicas=1, fanout=depth, seconds=1e-6, row_bytes=2048,
               window=depth + 1, rounds=depth + 1,
               bytes_moved=2048 * (depth + 1), joins=depth * (depth + 1),
               n_vars=depth)
    # consume the signature's compile-bucket slot outside the clock
    ledger.record("dataflow_fused", "OverheadProbe", **rec)

    def emission_pass(flag: bool) -> float:
        _registry.set_enabled(flag)
        try:
            t0 = time.perf_counter()
            for _ in range(emission_samples):
                with span("dataflow.propagate"):
                    pass
                g._emit_propagate_telemetry(stats, 1e-6)
                ledger.record("dataflow_fused", "OverheadProbe", **rec)
            return (time.perf_counter() - t0) / emission_samples
        finally:
            _registry.set_enabled(prev)

    cost = max(0.0, emission_pass(True) - emission_pass(False))
    _registry.set_enabled(False)
    try:
        secs = []
        for _ in range(step_samples):
            # a fresh token re-dirties the whole chain
            store.update(src, ("add", "x"), "w")
            secs.append(_timed(g.propagate))
        prop_s = min(secs)
    finally:
        _registry.set_enabled(prev)
    return {
        "emission_cost_per_propagate_s": round(cost, 9),
        "propagate_seconds": round(prop_s, 6),
        "overhead_frac": round(cost / prop_s if prop_s > 0 else 0.0, 4),
        "edges": len(g.edges),
        "sweeps_per_propagate": depth + 1,
        "emission_samples": emission_samples,
    }


def _measure_flight(step_samples: int, emission_samples: int, dev,
                    n_replicas: int = 256, block: int = 8) -> dict:
    """Flight-recorder arm: a fused window carries the ring on the device
    (the ring's allocation and the block's one copy of its rounds, timed
    with and without, each timing ending on a sync) and pays one host drain
    a window
    (``_drain_flight``: decode, monitor feed, per-round delivery events,
    the window log — enabled minus disabled). The sum is held against the
    fused window itself."""
    import torch

    from ..dataflow import Graph
    from ..mesh import ReplicatedRuntime
    from ..mesh.topology import ring as ring_topo
    from ..store import Store
    from . import device as _device

    prev = _registry.enabled()
    store = Store(n_actors=8, device=dev)
    v = store.declare(type="lasp_orset", n_elems=64)
    rt = ReplicatedRuntime(store, Graph(store), n_replicas,
                           ring_topo(n_replicas, 2), device=dev)
    rt.update_batch(v, [(r % n_replicas, ("add", f"x{r}"), f"w{r}") for r in range(8)])
    rt.begin_fused_steps(block).finish()  # warm (ring carried)

    n_vars = len(rt.var_ids)
    flight_k = _device.flight_rounds()
    rec = torch.ones((n_vars,), dtype=torch.int32, device=dev)

    def writes(with_ring: bool):
        # the fused block's ring: made, then its rounds landed in one copy
        ring = _device.ring_init(flight_k, n_vars, device=dev) if with_ring else rec
        if with_ring:
            _device.ring_write_block(ring, 0, [rec] * block)
        ring.sum().item()  # the window's sync

    writes(True)
    writes(False)
    ring_cost = max(0.0, min(_timed(lambda: writes(True)) for _ in range(step_samples))
                    - min(_timed(lambda: writes(False)) for _ in range(step_samples)))

    host_ring = np.tile(np.arange(1, block + 1, dtype=np.int32)[:, None], (1, n_vars))
    host_ring = np.vstack(
        [host_ring, np.zeros((max(flight_k - block, 0), n_vars), np.int32)]
    )

    def drain_pass(flag: bool) -> float:
        _registry.set_enabled(flag)
        try:
            t0 = time.perf_counter()
            for _ in range(emission_samples):
                rt._drain_flight("fused_block", host_ring, block, True, 1e-6)
            return (time.perf_counter() - t0) / emission_samples
        finally:
            _registry.set_enabled(prev)

    drain_cost = max(0.0, drain_pass(True) - drain_pass(False))
    _registry.set_enabled(False)
    try:
        window_s = min(_timed(lambda: rt.begin_fused_steps(block).finish())
                       for _ in range(step_samples))
    finally:
        _registry.set_enabled(prev)
    total = ring_cost + drain_cost
    return {
        "ring_write_cost_per_window_s": round(ring_cost, 9),
        "drain_cost_per_window_s": round(drain_cost, 9),
        "window_seconds": round(window_s, 6),
        "overhead_frac": round(total / window_s if window_s > 0 else 0.0, 4),
        "flight_rounds": flight_k,
        "block": block,
        "n_replicas": n_replicas,
    }


def _measure_aae(step_samples: int, emission_samples: int, dev,
                 n_replicas: int = 256, n_vars: int = 24) -> dict:
    """Incremental-rehash arm: the steady-state ``HashForest.refresh()``
    (quiescent variables cost a dict walk) priced against an active
    frontier round; the dirty-row and full-rebuild refreshes ride along as
    the incremental-against-full comparison."""
    from ..aae import HashForest

    prev = _registry.enabled()
    rt, ids, one_active_round = _frontier_runtime(dev, n_replicas, n_vars, 16, 11)
    # the denominator first, before any forest attaches
    _registry.set_enabled(False)
    try:
        round_s = min(_timed(one_active_round) for _ in range(step_samples))
    finally:
        _registry.set_enabled(prev)

    forest = HashForest(rt)
    forest.refresh()  # commit the baseline
    t0 = time.perf_counter()
    for _ in range(emission_samples):
        forest.refresh()  # every var quiescent: the steady-state cost
    quiescent_cost = (time.perf_counter() - t0) / emission_samples

    hot = [0, n_replicas // 2]

    def dirty_refresh():
        for v in ids[: max(2, n_vars // 8)]:
            rt._aae_mark(v, hot)
        forest.refresh()

    dirty_refresh()
    dirty_s = min(_timed(dirty_refresh) for _ in range(step_samples))

    def full_rebuild():
        for v in ids:
            rt._aae_mark(v, None)
        forest.refresh()

    full_rebuild()
    full_s = min(_timed(full_rebuild) for _ in range(step_samples))
    return {
        "refresh_cost_quiescent_s": round(quiescent_cost, 9),
        "round_seconds": round(round_s, 6),
        "overhead_frac": round(quiescent_cost / round_s if round_s > 0 else 0.0, 4),
        "dirty_refresh_seconds": round(dirty_s, 6),
        "full_rebuild_seconds": round(full_s, 6),
        "incremental_vs_full": round(full_s / dirty_s if dirty_s > 0 else 0.0, 2),
        "n_vars": n_vars,
        "n_replicas": n_replicas,
    }


def _measure_ledger(emission_samples: int, step_s: float, round_s: float,
                    dispatches_per_round: int) -> dict:
    """Kernel-cost-ledger arm: one ``ledger.record`` a dispatch (the model,
    the locked dict update, its share of the sampled gauge refresh) — a
    dense round books one store record, a planned frontier round one per
    group dispatch."""
    prev = _registry.enabled()
    ledger = _roofline.get_ledger()
    # consume the signature's compile-bucket slot outside the clock
    ledger.record("rows", "OverheadProbe", n_replicas=1024, fanout=3,
                  seconds=1e-6, row_bytes=64, rows=16)

    def record_pass(flag: bool) -> float:
        _registry.set_enabled(flag)
        try:
            t0 = time.perf_counter()
            for _ in range(emission_samples):
                ledger.record("rows", "OverheadProbe", n_replicas=1024, fanout=3,
                              seconds=1e-6, row_bytes=64, rows=16)
            return (time.perf_counter() - t0) / emission_samples
        finally:
            _registry.set_enabled(prev)

    cost = max(0.0, record_pass(True) - record_pass(False))
    per_round = cost * max(dispatches_per_round, 1)
    return {
        "cost_per_record_s": round(cost, 9),
        "dense_overhead_frac": round(cost / step_s if step_s > 0 else 0.0, 4),
        "frontier_overhead_frac": round(
            per_round / round_s if round_s > 0 else 0.0, 4
        ),
        "emission_samples": emission_samples,
    }


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0
