#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``lasp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

1. build    — compile every CUDA kernel of the port from
               ``lasp_tpu_torch/ops/csrc`` (one ``nvcc`` per source, all at
               once) into ``build/lasp_tpu_torch``;
2. parity   — hold each kernel (K1, K2, K3) bit-for-bit against its plain
               PyTorch version on the card (tolerance zero: every value is
               a bit or an integer), changed flags included;
3. headline — ``bench_scenarios.orset_anti_entropy`` at 2**18 replicas of
               the 8 KiB packed OR-Set (128 elems x 64 actors x 4 tokens),
               random 3-regular gossip, fused blocks of 4;
4. engine   — ``Store`` + ``ReplicatedRuntime(packed=True)`` at 100,000
               replicas on ``random_regular(100_000, 3)``: an OR-Set and a
               G-Counter written with ``update_batch``, converged by a dense
               twin and a frontier twin that must agree bit for bit;
5. plan     — the grouped dispatch plan at 100,000 replicas on
               ``random_regular(100_000, 3, seed=23)``: 48 variables cycling
               G-Set / G-Counter / OR-SWOT (16 of each), 16 writers each and
               one hot G-Set, converged by ``plan="off"`` and ``plan="auto"``
               frontier twins and a dense twin that must agree bit for bit;
               K2 and K3 must launch with G > 1; a fourth ``plan="auto"``
               twin converges under ``torch.profiler`` for the card's busy
               share;
6. kernels  — each kernel timed at the shapes phases 3-5 gave it (device
               time, and host time per wrapper call), beside its plain
               version and its bound, with its launches on phases 3-5
               (counts zeroed before each phase, read after).

Prints the card's name and power limit, one JSON line of kernels, and as
the last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when CUDA is unavailable or anything fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def _log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _peak_hbm_gbps(name: str) -> float:
    """Published HBM bandwidth of the card (NVIDIA data sheets)."""
    if "H200" in name:
        return 4800.0
    if "H100" in name:
        if "PCIe" in name:
            return 2000.0
        if "NVL" in name:
            return 3900.0
        return 3350.0  # H100 SXM
    raise RuntimeError(f"no published HBM bandwidth on record for {name!r}")


#: clock cycles the card spins before a timed window (~0.5 s at H100 clocks)
_QUEUE_AHEAD_CYCLES = 1_000_000_000


def _time_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds per call over ``reps`` calls, by CUDA
    events, after one warm call. The card first spins on a sleep kernel
    while the host enqueues the whole window, so the events time the
    device's work and not the wrappers' host overhead (a kernel shorter
    than its wrapper's Python would otherwise be timed at the host's
    launch rate). Fails if the host took longer to enqueue than the card
    slept."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin = torch.cuda.Event()
    torch.cuda._sleep(_QUEUE_AHEAD_CYCLES)
    spin.record()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if spin.query():
        raise RuntimeError("timing window: the host enqueued slower than the card slept")
    end.synchronize()
    return start.elapsed_time(end) / reps


def _call_ms(torch, fn, reps: int) -> float:
    """Mean host milliseconds per call, wrapper overhead included: what a
    caller that waits for each result pays (host clock, synchronized)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _max_abs_err(torch, got, want) -> int:
    return max(
        int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
        if g.numel() else 0
        for g, w in zip(got, want)
    )


def phase_parity(torch, cg) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1234)

    def words(*shape):
        return torch.randint(
            -2**31, 2**31 - 1, shape, dtype=torch.int32, device="cuda",
            generator=gen,
        )

    # K1: R not a multiple of any block size; K in {2, 3, 8}; D in {2, 1024}
    # plus widths that take the 8-byte and 4-byte load paths
    for r, k, d in [(1003, 2, 2), (1003, 3, 1024), (1003, 8, 1024),
                    (1003, 8, 2), (517, 3, 3), (515, 3, 6)]:
        ex, rm = words(r, d), words(r, d)
        nb = torch.randint(0, r, (r, k), dtype=torch.int32, device="cuda",
                           generator=gen)
        got = cg.gossip_round_dense(ex, rm, nb)
        want = cg.gossip_round_dense_plain(ex, rm, nb)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"K1 disagrees with its plain version at R={r} K={k} D={d}")
        out = (torch.empty_like(ex), torch.empty_like(rm))
        got2 = cg.gossip_round_dense(ex, rm, nb, out=out)
        if got2[0].data_ptr() != out[0].data_ptr() or not torch.equal(got2[0], want[0]):
            raise RuntimeError("K1 out= buffers not honoured")
    _log("parity", "K1 gossip_round_dense: 6 shapes bit-identical to plain")

    # K2: dtype x op x mask x bucket (duplicates) x groups
    r, k = 1000, 3
    leaf_kinds = {
        "gset bool/or": (torch.bool, "or", (16,), 1),
        "gcounter int32/max": (torch.int32, "max", (4,), 1),
        "packed uint32/or": (torch.int32, "or", (16, 2), 2),
        "flat uint32/or": (torch.int32, "or", (128,), 2),
    }
    cases = 0
    for label, (dtype, op, row, n_leaves) in leaf_kinds.items():
        for g in (1, 3, 16):
            if dtype == torch.bool:
                leaves = [torch.randint(0, 2, (g, r) + row, device="cuda",
                                        generator=gen).bool()
                          for _ in range(n_leaves)]
            elif op == "max":
                leaves = [torch.randint(0, 50, (g, r) + row, dtype=torch.int32,
                                        device="cuda", generator=gen)
                          for _ in range(n_leaves)]
            else:
                leaves = [words(g, r, *row) for _ in range(n_leaves)]
            nb = torch.randint(0, r, (r, k), dtype=torch.int32, device="cuda",
                               generator=gen)
            for masked in (False, True):
                mask = (torch.rand((r, k), device="cuda", generator=gen) > 0.4
                        if masked else None)
                for bucket in (5, 16, 33):
                    rows = torch.randint(0, r, (g, bucket), device="cuda",
                                         generator=gen)
                    rows[:, -1] = rows[:, 0]  # a duplicate pad slot
                    got, ch = cg.gossip_round_rows(op, leaves, nb, rows, mask)
                    want, ch_w = cg.gossip_round_rows_plain(op, leaves, nb, rows, mask)
                    # the members as separate tensors, as the plan passes them
                    got_m, ch_m = cg.gossip_round_rows(
                        op, [[m.clone() for m in x.unbind(0)] for x in leaves],
                        nb, rows, mask)
                    torch.cuda.synchronize()
                    if not (all(torch.equal(a, b) for a, b in zip(got, want))
                            and all(torch.equal(a, b) for a, b in zip(got_m, want))
                            and torch.equal(ch, ch_w) and torch.equal(ch_m, ch_w)):
                        raise RuntimeError(
                            f"K2 disagrees with its plain version: {label} "
                            f"G={g} masked={masked} bucket={bucket}"
                        )
                    cases += 1
    _log("parity", f"K2 gossip_round_rows: {cases} cases bit-identical to plain "
                   "(rows and changed flags, stacked and member-list leaves)")
    _log("parity", f"K3 gossip_round_rows_vclock: {_parity_k3(torch, cg, gen)} "
                   "cases bit-identical to plain (clock, dots and changed flags)")


def _parity_k3(torch, cg, gen) -> int:
    """K3 against its plain version: A x E x K x mask x bucket x G, random
    clocks and dots (both versions skip dead edges, so any data will do),
    duplicate rows; then the grouped wrapper with ``valid`` on the card
    against itself on the CPU, with one quiescent member whose slots are
    all invalid."""
    from lasp_tpu_torch.lattice import ORSWOT, ORSWOTState

    r = 1000
    cases = 0
    for a in (4, 16):
        for e in (8, 64):
            for g in (1, 3, 16):
                clock = torch.randint(0, 7, (g, r, a), dtype=torch.int32,
                                      device="cuda", generator=gen)
                dots = torch.randint(0, 7, (g, r, e, a), dtype=torch.int32,
                                     device="cuda", generator=gen)
                dots = dots * (torch.rand((g, r, e, 1), device="cuda",
                                          generator=gen) < 0.5)
                if g > 1:  # a quiescent member: every replica holds one state
                    clock[-1] = clock[-1, :1]
                    dots[-1] = dots[-1, :1]
                for k in (2, 3, 8):
                    nb = torch.randint(0, r, (r, k), dtype=torch.int32,
                                       device="cuda", generator=gen)
                    for masked in (False, True):
                        mask = (torch.rand((r, k), device="cuda", generator=gen) > 0.4
                                if masked else None)
                        for bucket in (5, 16, 33):
                            rows = torch.randint(0, r, (g, bucket), device="cuda",
                                                 generator=gen)
                            rows[:, -1] = rows[:, 0]  # a duplicate pad slot
                            got, ch = cg.gossip_round_rows_vclock(
                                clock, dots, nb, rows, mask)
                            want, ch_w = cg.gossip_round_rows_vclock_plain(
                                clock, dots, nb, rows, mask)
                            torch.cuda.synchronize()
                            if not (all(torch.equal(x, y) for x, y in zip(got, want))
                                    and torch.equal(ch, ch_w)):
                                raise RuntimeError(
                                    f"K3 disagrees with its plain version: A={a} "
                                    f"E={e} K={k} G={g} masked={masked} "
                                    f"bucket={bucket}")
                            cases += 1
                if g > 1:
                    valid = torch.ones((g, 33), dtype=torch.bool, device="cuda")
                    valid[-1] = False
                    valid[0, 20:] = False
                    st = ORSWOTState(clock, dots)
                    got_s, got_c = cg.cuda_gossip_round_rows_grouped(
                        ORSWOT, None, st, nb, rows, valid, mask)
                    want_s, want_c = cg.cuda_gossip_round_rows_grouped(
                        ORSWOT, None, ORSWOTState(clock.cpu(), dots.cpu()),
                        nb.cpu(), rows.cpu(), valid.cpu(),
                        None if mask is None else mask.cpu())
                    if not (all(torch.equal(x.cpu(), y) for x, y in zip(got_s, want_s))
                            and torch.equal(got_c.cpu(), want_c)):
                        raise RuntimeError(f"K3 grouped round disagrees at G={g}")
                    if got_c[-1].any() or not (torch.equal(got_s.clock[-1], clock[-1])
                                               and torch.equal(got_s.dots[-1], dots[-1])):
                        raise RuntimeError("K3: the all-invalid quiescent member moved")
                    cases += 1
    return cases


def _engine(torch, n, nbrs):
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime
    from lasp_tpu_torch.store import Store

    store = Store(n_actors=16)
    ads = store.declare(id="ads", type="lasp_orset", n_elems=64, n_actors=16,
                        tokens_per_actor=4)
    views = store.declare(id="views", type="riak_dt_gcounter", n_actors=16)
    rt = ReplicatedRuntime(store, Graph(store), n, nbrs, packed=True)
    writers = np.random.RandomState(5).choice(n, 16, replace=False)
    expected = set()
    ops = []
    for a, r in enumerate(writers):
        mine = [f"ad{(a * 4 + j) % 64}" for j in range(4)]
        ops.append((int(r), ("add_all", mine), f"w{a}"))
        if a % 4 == 0:  # the writer withdraws its first ad again
            ops.append((int(r), ("remove", mine[0]), f"w{a}"))
            mine = mine[1:]
        expected.update(mine)
    rt.update_batch(ads, ops)
    rt.update_batch(views, [(int(r), ("increment", a + 1), f"w{a}")
                            for a, r in enumerate(writers)])
    return rt, (ads, views), expected, sum(range(1, 17))


#: the plan cell's variable kinds, cycled over v0..v47 (the JAX package's
#: ``bench_scenarios.many_vars`` schedule)
_PLAN_KINDS = ("lasp_gset", "riak_dt_gcounter", "riak_dt_orswot")


def _plan_twin(n, nbrs, plan):
    """A ``Store(n_actors=16)`` of 48 variables over ``n`` replicas, written
    with ``update_batch`` from ``RandomState(23)``: each variable at 16
    distinct rows, row i by actor ``w{i}``; ``v0`` also takes adds at
    ``n // 8`` hot rows. Returns ``(runtime, ids, expected coverage)``."""
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime
    from lasp_tpu_torch.store import Store

    store = Store(n_actors=16)
    ids = []
    for i in range(48):
        kind = _PLAN_KINDS[i % 3]
        caps = ({"n_elems": 64} if kind == "lasp_gset" else
                {"n_actors": 16} if kind == "riak_dt_gcounter" else
                {"n_elems": 64, "n_actors": 16})
        ids.append(store.declare(id=f"v{i}", type=kind, **caps))
    rt = ReplicatedRuntime(store, Graph(store), n, nbrs, plan=plan)
    rng = np.random.RandomState(23)
    expected = {}
    for j, v in enumerate(ids):
        kind = _PLAN_KINDS[j % 3]
        rows = rng.choice(n, 16, replace=False)
        if kind == "lasp_gset":
            ops = [(int(r), ("add", f"g{i}"), f"w{i}") for i, r in enumerate(rows)]
            expected[v] = {f"g{i}" for i in range(16)}
            if j == 0:  # the hot variable
                hot = rng.choice(n, n // 8, replace=False)
                ops += [(int(r), ("add", f"h{r % 48}"), f"h{r}") for r in hot]
                expected[v] |= {f"h{r % 48}" for r in hot}
        elif kind == "riak_dt_gcounter":
            ops = [(int(r), ("increment", i + 1), f"w{i}") for i, r in enumerate(rows)]
            expected[v] = sum(range(1, 17))
        else:
            ops, expected[v] = [], set()
            for i, r in enumerate(rows):
                mine = [f"e{2 * i}", f"e{2 * i + 1}"]
                ops.append((int(r), ("add_all", mine), f"w{i}"))
                if i % 4 == 0:  # the writer removes its first element again
                    ops.append((int(r), ("remove", mine[0]), f"w{i}"))
                    mine = mine[1:]
                expected[v].update(mine)
        rt.update_batch(v, ops)
    return rt, ids, expected


def _device_busy(torch, fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: wall seconds (host clock,
    synchronized), device seconds (the CUDA kernels' and copies' own time)
    and the five device activities that took longest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e6
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:5]
    return {"wall_s": wall, "device_s": busy, "device_share": busy / wall,
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count] for e in top]}


def phase_plan(torch, cg, n: int) -> dict:
    """Three twins of the 48-variable store: frontier with ``plan="off"``,
    frontier with ``plan="auto"`` and dense; then a fourth, ``plan="auto"``
    frontier twin converged under the profiler for the device's busy share.
    Returns what the kernels phase needs: the auto twin, its widest planned
    sparse round per kernel and the launches."""
    from lasp_tpu_torch.mesh import random_regular

    nbrs = random_regular(n, 3, seed=23)
    runs, widest = {}, {}
    cg.reset_launches()
    for label, plan, mode in (("off", "off", "frontier"), ("auto", "auto", "frontier"),
                              ("dense", "auto", "dense")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt, ids, expected = _plan_twin(n, nbrs, plan)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if label == "auto":
            rows_round = rt._rows_round

            def recording(var_ids, row_idx, mask, _rt=rt, _inner=rows_round):
                codec, spec = _rt._mesh_meta(var_ids[0])
                kind = cg.rows_plan_of(codec, spec, _rt.states[var_ids[0]]).kind
                g, f = row_idx.shape
                if g * f > widest.get(kind, {}).get("slots", 0):
                    widest[kind] = {"slots": g * f, "G": g, "F": f,
                                    "var_ids": tuple(var_ids), "rows": row_idx.clone()}
                widest.setdefault(f"{kind}_max_G", 0)
                widest[f"{kind}_max_G"] = max(widest[f"{kind}_max_G"], g)
                return _inner(var_ids, row_idx, mask)

            rt._rows_round = recording
        rounds = rt.run_to_convergence(mode=mode)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        runs[label] = {"rt": rt, "rounds": rounds, "seconds": t2 - t0,
                       "setup_s": t1 - t0, "converge_s": t2 - t1}
    launches = dict(cg.LAUNCHES)
    off, auto, dense = runs["off"]["rt"], runs["auto"]["rt"], runs["dense"]["rt"]
    if not runs["off"]["rounds"] == runs["auto"]["rounds"] == runs["dense"]["rounds"]:
        raise RuntimeError(f"plan: round counts differ: "
                           f"{ {k: v['rounds'] for k, v in runs.items()} }")
    if off.round_residuals != auto.round_residuals:
        raise RuntimeError("plan: per-round residuals differ between plan=off and auto")
    for v in ids:
        for other in (off, dense):
            if not all(torch.equal(a, b) for a, b in zip(auto.states[v], other.states[v])):
                raise RuntimeError(f"plan: states of {v} differ between twins")
        if auto.divergence(v) != 0:
            raise RuntimeError(f"plan: {v} did not converge")
        if auto.coverage_value(v) != expected[v]:
            raise RuntimeError(f"plan: coverage of {v} is {auto.coverage_value(v)!r}, "
                               f"expected {expected[v]!r}")
    describe = auto._ensure_plan().describe()
    del off, dense
    for label in ("off", "dense"):
        del runs[label]["rt"]
    probe, _ids, _expected = _plan_twin(n, nbrs, "auto")
    busy = _device_busy(torch, lambda: probe.run_to_convergence(mode="frontier"))
    del probe
    cg.LAUNCHES.update(launches)  # the profiled twin's launches are not counted
    _log("plan", json.dumps({
        "replicas": n, "vars": len(ids), "rounds": runs["auto"]["rounds"],
        "seconds": {k: v["seconds"] for k, v in runs.items()},
        "setup_s": {k: v["setup_s"] for k, v in runs.items()},
        "converge_s": {k: v["converge_s"] for k, v in runs.items()},
        "profiled_auto_converge": busy,
        "peak_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
        "residuals": auto.round_residuals, "describe": describe,
        "widest_sparse": {k: {"G": w["G"], "F": w["F"]} for k, w in widest.items()
                          if isinstance(w, dict)},
        "max_G": {k: w for k, w in widest.items() if not isinstance(w, dict)},
    }))
    if launches["gossip_round_rows_vclock"] == 0:
        raise RuntimeError("the plan phase never launched K3")
    for kind in ("leafwise", "vclock"):
        if widest.get(f"{kind}_max_G", 0) < 2:
            raise RuntimeError(f"the plan phase never launched the {kind} kernel at G > 1")
    return {"rt": auto, "widest": widest, "launches": launches,
            "nbrs": nbrs, "ids": ids}


def _k3_at_plan_shape(torch, cg, plan, bw) -> dict:
    """K3 at the widest planned OR-SWOT round of the plan phase: the same
    members and row table, on the converged populations (the kernel's work
    does not depend on the values). Returns the kernels-line fields."""
    w3 = plan["widest"]["vclock"]
    rt = plan["rt"]
    members = [rt.states[v] for v in w3["var_ids"]]
    clocks = [m.clock for m in members]
    dotss = [m.dots for m in members]
    rows, nb = w3["rows"], rt.neighbors
    got, ch = cg.gossip_round_rows_vclock(clocks, dotss, nb, rows)
    stacked_c, stacked_d = torch.stack(clocks), torch.stack(dotss)
    want, ch_w = cg.gossip_round_rows_vclock_plain(stacked_c, stacked_d, nb, rows)
    err = max(_max_abs_err(torch, got, want), int((ch.int() - ch_w.int()).abs().max()))
    del got, want
    ms = _time_ms(torch, lambda: cg.gossip_round_rows_vclock(clocks, dotss, nb, rows), 20)
    call_ms = _call_ms(
        torch, lambda: cg.gossip_round_rows_vclock(clocks, dotss, nb, rows), 20)
    plain_ms = _time_ms(
        torch, lambda: cg.gossip_round_rows_vclock_plain(stacked_c, stacked_d, nb, rows), 3)
    del stacked_c, stacked_d
    g, f = rows.shape
    k = nb.shape[1]
    a, e = clocks[0].shape[1], dotss[0].shape[1]
    row_bytes = 4 * (a + e * a)
    rows_np, nbrs = rows.cpu().numpy(), plan["nbrs"]
    # each distinct row a member's round reads (own and neighbours), once
    distinct = sum(np.unique(np.concatenate([r, nbrs[np.unique(r)].ravel()])).size
                   for r in rows_np)
    bound_bytes = (distinct * row_bytes + g * f * 4
                   + sum(np.unique(r).size for r in rows_np) * k * 4
                   + g * f * row_bytes + g * f * 4)
    gather_bytes = (k + 2) * g * f * row_bytes + g * f * 4 * (k + 1)
    return {
        "max_abs_err": err, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
        "bound_ms": float(bound_bytes) / bw * 1e3, "bound_by": "bytes",
        "gather_model_bound_ms": gather_bytes / bw * 1e3,
        "shape": {"G": int(g), "F": int(f), "R": rt.n_replicas, "A": int(a),
                  "E": int(e), "K": int(k)},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from lasp_tpu_torch.bench_scenarios import orset_anti_entropy
    from lasp_tpu_torch.bridge_state import to_numpy
    from lasp_tpu_torch.mesh import random_regular
    from lasp_tpu_torch.ops import _build
    from lasp_tpu_torch.ops import cuda_gossip as cg

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peak_gbps = _peak_hbm_gbps(kind)
    _log("device", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda} "
                   f"| published HBM peak {peak_gbps} GB/s")

    # 1. build ------------------------------------------------------------------
    secs = _build.build_all()
    _log("build", f"{len(_build.SOURCES)} kernels built in {secs:.2f} s")
    for name in _build.SOURCES:
        report = Path(f"{_build.library_path(name)}.ptxas.txt").read_text()
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                _log("build", f"{name}: {line.strip()}")

    # 2. parity -----------------------------------------------------------------
    phase_parity(torch, cg)

    launches: dict = {}
    # 3. headline ---------------------------------------------------------------
    cg.reset_launches()
    head = orset_anti_entropy(1 << 18, fanout=3, block=4, n_elems=128,
                              n_actors=64, tokens_per_actor=4)
    torch.cuda.synchronize()
    launches["headline"] = dict(cg.LAUNCHES)
    if head["check"] != "converged+all-live":
        raise RuntimeError("headline did not converge with every element live")
    _log("headline", json.dumps({
        k: head[k] for k in ("scenario", "rounds", "seconds", "merges_per_sec",
                             "achieved_GBps", "state_bytes_per_replica")
    } | {"share_of_peak_hbm": head["achieved_GBps"] / peak_gbps,
         "productive_rounds_per_block":
             head["convergence"]["productive_rounds_per_block"],
         "seconds_each": head["timing"]["seconds_each"]}))

    # 4. engine -----------------------------------------------------------------
    n = 100_000
    nbrs = random_regular(n, 3, seed=0)
    cg.reset_launches()
    t0 = time.perf_counter()
    rt_d, ids, expected, total = _engine(torch, n, nbrs)
    rounds_d = rt_d.run_to_convergence(mode="dense")
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    rt_f, _, _, _ = _engine(torch, n, nbrs)
    # keep the state and rows of the widest sparse OR-Set round (timed below)
    widest: dict = {}
    sparse_round = rt_f._frontier_sparse_round

    def recording(var_id, rows, edge_mask):
        if var_id == ids[0] and rows.size > widest.get("size", 0):
            widest.update(size=rows.size, rows=rows.copy(),
                          states=tuple(x.clone() for x in rt_f.states[var_id]),
                          bucket=rt_f._frontier_bucket(rows.size))
        return sparse_round(var_id, rows, edge_mask)

    rt_f._frontier_sparse_round = recording
    t0 = time.perf_counter()
    rounds_f = rt_f.run_to_convergence(mode="frontier")
    torch.cuda.synchronize()
    t_frontier = time.perf_counter() - t0
    launches["engine"] = dict(cg.LAUNCHES)
    if rounds_d != rounds_f:
        raise RuntimeError(f"engine: dense took {rounds_d} rounds, frontier {rounds_f}")
    for v in ids:
        for a, b in zip(to_numpy(rt_d.states[v]), to_numpy(rt_f.states[v])):
            if not np.array_equal(a, b):
                raise RuntimeError(f"engine: dense and frontier states differ on {v}")
        if rt_d.divergence(v) != 0 or rt_f.divergence(v) != 0:
            raise RuntimeError(f"engine: {v} did not converge")
    if rt_d.coverage_value(ids[0]) != expected or rt_f.coverage_value(ids[0]) != expected:
        raise RuntimeError("engine: OR-Set coverage value is wrong")
    if rt_d.coverage_value(ids[1]) != total or rt_f.coverage_value(ids[1]) != total:
        raise RuntimeError("engine: G-Counter coverage value is wrong")
    _log("engine", json.dumps({
        "replicas": n, "rounds": rounds_d, "dense_seconds": t_dense,
        "frontier_seconds": t_frontier, "coverage_elems": len(expected),
        "counter": total, "widest_sparse_rows": widest.get("size"),
    }))
    for phase, counts in launches.items():
        _log("launches", f"{phase}: {counts}")
    if launches["headline"]["gossip_round_dense"] == 0:
        raise RuntimeError("the headline never launched K1")
    if launches["engine"]["gossip_round_dense"] == 0:
        raise RuntimeError("the engine path never launched K1")
    if launches["engine"]["gossip_round_rows"] == 0:
        raise RuntimeError("the engine path never launched K2")
    del rt_d, rt_f

    # 5. plan ---------------------------------------------------------------------
    plan = phase_plan(torch, cg, n)
    launches["plan"] = plan["launches"]
    _log("launches", f"plan: {launches['plan']}")

    # 6. kernels at the main path's shapes ----------------------------------------
    bw = peak_gbps * 1e9
    # K1 at the headline shape: R = 2**18, D = 128 elems x 8 words, K = 3
    r, d, k = 1 << 18, 128 * 8, 3
    gen = torch.Generator(device="cuda").manual_seed(7)
    ex = torch.randint(-2**31, 2**31 - 1, (r, d), dtype=torch.int32,
                       device="cuda", generator=gen)
    rm = ex & torch.randint(-2**31, 2**31 - 1, (r, d), dtype=torch.int32,
                            device="cuda", generator=gen)
    nb = torch.as_tensor(random_regular(r, k, seed=7), device="cuda")
    base = dict(cg.LAUNCHES)
    got = cg.gossip_round_dense(ex, rm, nb)
    want = cg.gossip_round_dense_plain(ex, rm, nb)
    k1_err = _max_abs_err(torch, got, want)
    del got, want
    out = (torch.empty_like(ex), torch.empty_like(rm))
    k1_ms = _time_ms(torch, lambda: cg.gossip_round_dense(ex, rm, nb, out=out), 20)
    k1_call_ms = _call_ms(torch, lambda: cg.gossip_round_dense(ex, rm, nb, out=out), 20)
    k1_plain_ms = _time_ms(torch, lambda: cg.gossip_round_dense_plain(ex, rm, nb), 3)
    row_bytes = 2 * d * 4
    k1_bytes = 2 * r * row_bytes + r * k * 4  # planes in + out, indices once
    k1_gather_bytes = (k + 2) * r * row_bytes
    del ex, rm, out
    # K2 at the widest sparse round of the engine's frontier run
    states = widest["states"]
    rows_np = widest["rows"]
    padded = np.full(widest["bucket"], rows_np[0], dtype=np.int64)
    padded[: rows_np.size] = rows_np
    rows_t = torch.as_tensor(padded, device="cuda")[None]
    leaves = [x[None] for x in states]
    nb_e = torch.as_tensor(nbrs, device="cuda")
    got, ch = cg.gossip_round_rows("or", leaves, nb_e, rows_t)
    want, ch_w = cg.gossip_round_rows_plain("or", leaves, nb_e, rows_t)
    k2_err = max(_max_abs_err(torch, got, want),
                 int((ch.int() - ch_w.int()).abs().max()))
    k2_ms = _time_ms(torch, lambda: cg.gossip_round_rows("or", leaves, nb_e, rows_t), 50)
    k2_call_ms = _call_ms(torch, lambda: cg.gossip_round_rows("or", leaves, nb_e, rows_t), 50)
    k2_plain_ms = _time_ms(
        torch, lambda: cg.gossip_round_rows_plain("or", leaves, nb_e, rows_t), 10)
    f = padded.size
    w2 = states[0].shape[1]
    row2 = 2 * w2 * 4
    distinct = np.unique(np.concatenate([padded, nbrs[np.unique(padded)].ravel()]))
    k2_bytes = (distinct.size * row2 + f * 4 + np.unique(padded).size * k * 4
                + f * row2 + f * 4)
    k2_gather_bytes = (k + 2) * f * row2 + f * 4 * (k + 1)
    del states, leaves, got, want, widest
    k3 = _k3_at_plan_shape(torch, cg, plan, bw)
    cg.LAUNCHES.update(base)  # timing launches are not main-path launches

    def total_launches(name):
        return sum(c[name] for c in launches.values())

    kernels = [
        {
            "name": "gossip_round_dense", "route": "cuda",
            "source": "lasp_tpu_torch/ops/csrc/gossip_round_dense.cu",
            "replaces": "lasp_tpu/ops/pallas_gossip.py:125",
            "launches": total_launches("gossip_round_dense"),
            "launches_by_phase": {p: c["gossip_round_dense"] for p, c in launches.items()},
            "max_abs_err": k1_err, "ms": k1_ms, "call_ms": k1_call_ms,
            "plain_ms": k1_plain_ms,
            "bound_ms": k1_bytes / bw * 1e3, "bound_by": "bytes",
            "gather_model_bound_ms": k1_gather_bytes / bw * 1e3,
            "library_ms": None,
            "shape": {"R": r, "D_words": d, "K": k},
        },
        {
            "name": "gossip_round_rows", "route": "cuda",
            "source": "lasp_tpu_torch/ops/csrc/gossip_round_rows.cu",
            "replaces": "lasp_tpu/ops/pallas_gossip.py:439",
            "launches": total_launches("gossip_round_rows"),
            "launches_by_phase": {p: c["gossip_round_rows"] for p, c in launches.items()},
            "max_abs_err": k2_err, "ms": k2_ms, "call_ms": k2_call_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": float(k2_bytes) / bw * 1e3, "bound_by": "bytes",
            "gather_model_bound_ms": k2_gather_bytes / bw * 1e3,
            "library_ms": None,
            "shape": {"G": 1, "F": int(f), "R": n, "W_words": int(w2),
                      "leaves": 2, "K": k},
        },
        {
            "name": "gossip_round_rows_vclock", "route": "cuda",
            "source": "lasp_tpu_torch/ops/csrc/gossip_round_rows.cu",
            "replaces": "lasp_tpu/ops/pallas_gossip.py:439",
            "launches": total_launches("gossip_round_rows_vclock"),
            "launches_by_phase": {p: c["gossip_round_rows_vclock"]
                                  for p, c in launches.items()},
            **k3, "library_ms": None,
        },
    ]
    if k1_err or k2_err or k3["max_abs_err"]:
        raise RuntimeError(f"kernel disagrees with plain at the main-path shape: {kernels}")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1,  # the cards this run used
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
