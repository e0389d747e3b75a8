"""The port's CLI (``python -m lasp_tpu_torch.cli``) against the JAX
package's, in process through ``main([..., "--device", "cpu"])``: twins of
``tests/utils/test_cli_top_trace.py`` (``top``, ``trace``), of
``tests/utils/test_cli_metrics.py`` where the port carries the verb
(``status``, ``simulate``, ``inspect``, the runtime's residual record; JAX's
``StepTrace`` and ``jax.profiler`` wrappers are not carried: ``roofline
--profile`` records with ``torch.profiler``), the JSON of the deterministic
verbs equal to JAX's, the literal choice lists pinned to the registries,
and argument parsing that imports no torch."""

import json
import subprocess
import sys

import pytest
import torch

from lasp_tpu import cli as jcli
from lasp_tpu import telemetry as jtelemetry
from lasp_tpu.telemetry import events as JE
from lasp_tpu_torch import cli
from lasp_tpu_torch import telemetry
from lasp_tpu_torch.telemetry import events as E

torch.set_num_threads(1)


def _main(argv) -> int:
    return cli.main(list(argv) + ["--device", "cpu"])


def _both(argv, capsys) -> tuple:
    """``argv`` through JAX's CLI and the port's: both JSON outputs."""
    assert jcli.main(list(argv)) == 0
    want = json.loads(capsys.readouterr().out)
    assert _main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    return got, want


# -- twins of tests/utils/test_cli_metrics.py --------------------------------


def test_cli_status(capsys):
    assert _main(["status"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["platform"] == "cpu"
    assert out["devices"] == ["cpu"]
    assert out["torch"] == torch.__version__


def test_cli_simulate(capsys):
    argv = ["simulate", "--replicas", "64", "--topology", "ring", "--writers", "4"]
    got, want = _both(argv, capsys)
    for key in ("replicas", "topology", "rounds_to_convergence",
                "residual_path", "value_size"):
        assert got[key] == want[key], key
    assert got["residual_path"][-1] == 0 and got["value_size"] == 4


def test_cli_inspect_checkpoint(tmp_path, capsys):
    """The port's checkpoint through both CLIs' ``inspect``: one listing."""
    from lasp_tpu_torch.store import Store
    from lasp_tpu_torch.store.checkpoint import save_store

    store = Store(n_actors=4, device="cpu")
    v = store.declare(type="lasp_gset", n_elems=4)
    store.update(v, ("add", "x"), "w")
    path = str(tmp_path / "c.log")
    save_store(store, path)
    got, want = _both(["inspect", path], capsys)
    assert got == want
    assert got["kind"] == "store" and got["vars"][v] == "lasp_gset"


def test_runtime_records_residuals():
    """JAX's ``rt.trace`` residual path is the port's ``round_residuals``."""
    import lasp_tpu.dataflow as jdf
    import lasp_tpu.mesh as jmesh
    import lasp_tpu.store as jstore
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime, ring
    from lasp_tpu_torch.store import Store

    js = jstore.Store(n_actors=4)
    jv = js.declare(type="lasp_gset", n_elems=4)
    jrt = jmesh.ReplicatedRuntime(js, jdf.Graph(js), 8, jmesh.ring(8, 2))
    jrt.update_at(0, jv, ("add", "x"), "w")
    jrounds = jrt.run_to_convergence(max_rounds=16)
    store = Store(n_actors=4, device="cpu")
    v = store.declare(type="lasp_gset", n_elems=4)
    rt = ReplicatedRuntime(store, Graph(store), 8, ring(8, 2), device="cpu")
    rt.update_at(0, v, ("add", "x"), "w")
    rounds = rt.run_to_convergence(max_rounds=16)
    assert rounds == jrounds
    assert rt.round_residuals == jrt.trace.summary()["residual_path"]
    assert rt.round_residuals[-1] == 0


def test_cli_simulate_gcounter_value_key(capsys):
    argv = ["simulate", "--replicas", "32", "--topology", "ring",
            "--writers", "4", "--type", "riak_dt_gcounter"]
    got, want = _both(argv, capsys)
    assert got["value"] == want["value"] == 4
    assert "value_size" not in got
    assert got["residual_path"] == want["residual_path"]


def test_cli_roofline_profile_writes_chrome_trace(tmp_path, capsys):
    """``roofline --profile DIR``: the workload under ``torch.profiler``,
    its Chrome trace in DIR (JAX writes a ``jax.profiler`` trace)."""
    d = tmp_path / "prof"
    assert _main(["roofline", "--replicas", "16", "--rounds", "1",
                  "--profile", str(d)]) == 0
    doc = json.loads((d / "trace.json").read_text())
    assert doc["traceEvents"]
    assert "profile trace:" in capsys.readouterr().out


def test_cli_roofline_export_families_map_to_jax(tmp_path, capsys):
    """``roofline --export``: the port's ledger families are JAX's, the
    Pallas families as their CUDA counterparts; JAX's ``shard_exchange``
    wave is the one family the port does not run (sharding, ROADMAP A5).
    Off the card the capability row has no peak: ``roofline_frac`` is
    null rather than a CPU number under a device name."""
    exports = {}
    for name, run in (("jax", jcli.main), ("torch", _main)):
        telemetry.reset()
        jtelemetry.reset()
        path = tmp_path / f"{name}.json"
        assert run(["roofline", "--replicas", "32", "--rounds", "1",
                    "--export", str(path)]) == 0
        capsys.readouterr()
        exports[name] = json.loads(path.read_text())
    mapped = {"pallas_dense": "cuda_dense", "pallas_rows": "cuda_rows"}

    def families(doc, rename=None):
        fams = {k["kernel"].split(":")[0] for k in doc["kernels"]}
        return {(rename or {}).get(f, f) for f in fams}

    want = families(exports["jax"], mapped) - {"shard_exchange"}
    assert families(exports["torch"]) == want
    assert {"cuda_dense", "cuda_rows", "dataflow_fused"} <= want
    assert exports["torch"]["summary"]["roofline_frac"] is None
    assert exports["torch"]["capability"]["peak_GBps"] is None


def test_cli_bench_runs_the_headline(capsys):
    assert _main(["bench", "--replicas", "256"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["check"] == "converged+all-live" and out["rounds"] > 0
    assert out["state_bytes_per_replica"] == 2 * 128 * 8 * 4
    assert out["device"] == "cpu"


def test_cli_scenario_matches_jax(capsys):
    got, want = _both(["scenario", "gset_1k"], capsys)
    for key in ("scenario", "rounds", "union_size", "intersection_size",
                "check"):
        assert got[key] == want[key], key


def test_cli_scenario_sharded_raises(capsys):
    """The sharded scenarios run through the CLI on the CPU's shard slots;
    a population too small for the shards raises JAX's error."""
    with pytest.raises(ValueError, match="needs >= 64 replicas"):
        _main(["scenario", "partitioned_gossip", "--replicas", "32"])
    got, want = _both(["scenario", "partitioned_gossip", "--replicas", "128"],
                      capsys)
    for key in ("scenario", "n_shards", "cut", "dense_allgather_bytes_per_round",
                "exchange_allgather_bytes_per_round", "alltoall_bytes_per_round"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("verb,argv,keys", [
    ("chaos", ["--preset", "ring-cut", "--replicas", "16", "--no-replay"],
     ("preset", "topology", "replicas", "schedule", "rounds_to_heal")),
    ("quorum", ["--preset", "rolling-crash", "--replicas", "16", "--writes",
                "6", "--reads", "4", "--no-replay"],
     ("preset", "replicas", "acked_writes", "lost_writes")),
    ("aae", ["--replicas", "16", "--no-replay"],
     ("preset", "replicas", "schedule", "detections")),
])
def test_cli_soak_verbs_match_jax(verb, argv, keys, capsys):
    got, want = _both([verb] + argv, capsys)
    for key in keys:
        if key in want:
            assert got[key] == want[key], key
    assert set(keys) & set(want)


# -- the CLI's own contract ---------------------------------------------------


def test_literal_choices_match_the_registries():
    from lasp_tpu_torch.bench_scenarios import SCENARIOS
    from lasp_tpu_torch.chaos import CORRUPTION_PRESETS, PRESETS

    import argparse

    parsers = {}

    def grab(self, args=None, namespace=None):
        parsers["p"] = self
        raise SystemExit(0)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            cli.main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    sub = next(a for a in parsers["p"]._actions
               if isinstance(a, argparse._SubParsersAction))

    def choices(verb, dest):
        return next(a.choices for a in sub.choices[verb]._actions if a.dest == dest)

    assert sorted(choices("scenario", "name")) == sorted(SCENARIOS)
    assert sorted(choices("chaos", "preset")) == sorted(PRESETS)
    assert sorted(choices("quorum", "preset")) == sorted(PRESETS)
    assert sorted(choices("aae", "preset")) == sorted(CORRUPTION_PRESETS)
    assert sorted(sub.choices) == sorted(
        ["status", "simulate", "bench", "chaos", "quorum", "aae", "serve",
         "scenario", "bridge", "metrics", "top", "trace", "flight",
         "roofline", "inspect"])


def test_help_imports_no_torch():
    code = (
        "import sys\n"
        "from lasp_tpu_torch.cli import main\n"
        "try:\n"
        "    main(['simulate', '--help'])\n"
        "except SystemExit:\n"
        "    pass\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax', 'lasp_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["simulate", "--replicas", "8"])


def test_cli_metrics_prometheus_text(capsys):
    """The built-in workload's scrape: the bridge's per-verb counters (the
    client wraps its update in ``idem``) and the instrumented layers'
    metric families, each also in JAX's scrape of the same workload."""
    def families(text):
        return {line.split()[2] for line in text.splitlines()
                if line.startswith("# TYPE")}

    jtelemetry.reset()
    assert jcli.main(["metrics", "--replicas", "4"]) == 0
    want = capsys.readouterr().out
    telemetry.reset()
    assert _main(["metrics", "--replicas", "4"]) == 0
    out = capsys.readouterr().out
    for verb in ("start", "declare", "idem", "read", "metrics"):
        assert f'bridge_requests_total{{verb="{verb}"}} 1' in out, verb
        assert f'bridge_requests_total{{verb="{verb}"}} 1' in want, verb
    assert {"bridge_requests_total", "bridge_request_seconds",
            "store_inflations_total"} <= families(out) & families(want)


def test_cli_flight_dumps_windows(tmp_path, capsys):
    path = tmp_path / "flight.json"
    assert _main(["flight", "--replicas", "16", "--export", str(path)]) == 0
    out = capsys.readouterr().out
    assert "converged in" in out and "flight windows retained" in out
    assert json.loads(path.read_text())


def test_cli_serve_soak_small(capsys):
    assert _main(["serve", "--replicas", "16", "--clients", "64", "--ticks",
                  "6", "--arrivals", "40", "--watches", "16", "--parity",
                  "64", "--no-chaos"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert "serve_health" in out


# -- twins of tests/utils/test_cli_top_trace.py --------------------------------


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset()
    E.clear()
    yield
    telemetry.reset()
    E.clear()


def test_cli_top_renders_live_mesh(capsys):
    rc = _main([
        "top", "--replicas", "16", "--iterations", "3",
        "--refresh", "0", "--shards", "4",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    frames = [f for f in out.split("---") if f.strip()]
    assert len(frames) == 3
    # the table names every workload variable with residual/stale/lag
    for var in ("ads", "seen_ads", "hits"):
        assert var in frames[0]
    assert "RESIDUAL" in frames[0] and "STALE" in frames[0]
    assert "shard lag: s0=" in frames[0] and "s3=" in frames[0]
    assert "worst replica:" in frames[0]
    # the observed mesh steps between frames: the round counter advances
    rounds = [
        int(line.split("round=")[1].split()[0])
        for line in out.splitlines()
        if line.startswith("convergence: round=")
    ]
    assert rounds == sorted(rounds) and rounds[0] < rounds[-1]


def test_cli_top_rejects_degenerate_population(capsys):
    assert _main(["top", "--replicas", "1", "--iterations", "1"]) == 2


def test_cli_top_bridge_scrape(capsys):
    from lasp_tpu_torch.bridge import BridgeServer

    with BridgeServer(port=0, device="cpu") as server:
        rc = _main([
            "top", "--bridge", f"127.0.0.1:{server.port}",
            "--iterations", "1", "--refresh", "0",
        ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "convergence: round=" in out
    assert "alerts: none" in out or "ALERT" in out


def test_cli_trace_exports_chrome_json(tmp_path, capsys):
    path = str(tmp_path / "trace.json")
    rc = _main([
        "trace", "--var", "seen_ads", "--export", path,
        "--replicas", "16",
    ])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["var"] == "seen_ads"
    # the lineage walks the map edge back to the source variable
    assert summary["lineage"] == {"seen_ads": ["ads"]}
    assert summary["events"] > 0
    doc = json.loads(open(path).read())
    evs = doc["traceEvents"]
    assert evs and all(
        {"name", "ph", "ts", "pid", "tid"} <= set(t) for t in evs
    )
    assert {t["ph"] for t in evs} <= {"X", "i"}
    # the causal history reaches the SOURCE updates through the edge
    updates = [
        t for t in evs
        if t["cat"] == "event" and t["name"] == "update"
    ]
    assert any(t["args"].get("var") == "ads" for t in updates)
    # population context (deliveries) rides along, ordered by ts
    assert any(t["name"] == "delivery" for t in evs)
    ts = [t["ts"] for t in evs]
    assert ts == sorted(ts)


def test_cli_trace_deep_carries_edge_provenance(tmp_path, capsys):
    path = str(tmp_path / "deep.json")
    rc = _main([
        "trace", "--var", "seen_ads", "--export", path,
        "--replicas", "8", "--deep",
    ])
    E.set_deep(False)
    assert rc == 0
    doc = json.loads(open(path).read())
    recomputes = [
        t for t in doc["traceEvents"] if t["name"] == "edge_recompute"
    ]
    assert recomputes, "deep trace must carry edge provenance"
    assert recomputes[0]["args"]["var"] == "seen_ads"
    assert recomputes[0]["args"]["srcs"] == ["ads"]


def _delivery_rounds(path):
    """Per-round (round, residual) pairs from a trace export's delivery
    markers, in round order."""
    doc = json.loads(open(path).read())
    out = [
        (t["args"]["round"], t["args"]["residual"])
        for t in doc["traceEvents"]
        if t.get("cat") == "event" and t["name"] == "delivery"
    ]
    out.sort()
    return out


def test_cli_trace_fused_window_has_real_round_records(tmp_path, capsys):
    """A fused-window convergence (--block > 1) must contribute REAL
    per-round delivery records to the trace — the flight recorder's
    whole point: the on-device ring carries what each in-block round
    did, where the pre-flight path logged one opaque marker."""
    path = str(tmp_path / "fused.json")
    rc = _main([
        "trace", "--var", "seen_ads", "--export", path,
        "--replicas", "16", "--block", "4",
    ])
    assert rc == 0
    rounds = _delivery_rounds(path)
    # one record per executed in-block round, with round provenance
    assert len(rounds) >= 2
    rs = [r for r, _res in rounds]
    assert rs == list(range(rs[0], rs[0] + len(rs)))
    # the drained records are attributed to the fused family
    doc = json.loads(open(path).read())
    assert any(
        t["args"].get("fused") == "fused_block"
        for t in doc["traceEvents"] if t["name"] == "delivery"
    )
    # the window reaches the fixed point: the residual curve ends at 0
    assert rounds[-1][1] == 0


def test_cli_trace_fused_and_unfused_round_curves_agree(tmp_path, capsys):
    """Same seeded workload, fused vs per-round stepping: the per-round
    residuals the flight ring drained must agree bit-for-bit with the
    unfused deliveries on every productive round (the fused block may
    append trailing no-op zeros — full blocks run to the block edge)."""
    p1 = str(tmp_path / "unfused.json")
    assert _main([
        "trace", "--var", "seen_ads", "--export", p1, "--replicas", "16",
    ]) == 0
    unfused = _delivery_rounds(p1)
    telemetry.reset()
    E.clear()
    p2 = str(tmp_path / "fused.json")
    assert _main([
        "trace", "--var", "seen_ads", "--export", p2,
        "--replicas", "16", "--block", "4",
    ]) == 0
    fused = _delivery_rounds(p2)
    res_unfused = [res for _r, res in unfused]
    res_fused = [res for _r, res in fused]
    # identical productive-round count and identical residual values;
    # any fused tail beyond the unfused run is all-zero no-ops
    assert len(res_fused) >= len(res_unfused)
    assert res_fused[: len(res_unfused)] == res_unfused
    assert all(r == 0 for r in res_fused[len(res_unfused):])


def test_cli_trace_unknown_var(tmp_path, capsys):
    rc = _main([
        "trace", "--var", "nope", "--export", str(tmp_path / "x.json"),
        "--replicas", "8",
    ])
    assert rc == 2


def test_cli_trace_rounds_match_jax(tmp_path, capsys):
    """The unfused trace of the observed mesh: the port's delivery records
    (round, residual) and summary equal JAX's, its causal history's event
    count too."""
    jtelemetry.reset()
    JE.clear()
    telemetry.reset()
    E.clear()
    jp, tp = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    argv = ["trace", "--var", "seen_ads", "--replicas", "16", "--export"]
    assert jcli.main(argv + [jp]) == 0
    want = json.loads(capsys.readouterr().out)
    assert _main(argv + [tp]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["lineage"] == want["lineage"]
    assert got["events"] == want["events"]
    assert _delivery_rounds(tp) == _delivery_rounds(jp)
