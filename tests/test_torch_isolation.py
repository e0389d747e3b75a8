"""The port stands alone: ``lasp_tpu_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor ``lasp_tpu``, and every entry point defaults to CUDA and
raises without it unless the caller passes ``device="cpu"``."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import lasp_tpu_torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "lasp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "lasp_tpu")


def _submodules() -> list:
    return sorted(
        m.name for m in pkgutil.walk_packages(
            lasp_tpu_torch.__path__, prefix="lasp_tpu_torch."
        )
    )


def test_scans_cover_every_ported_module():
    """The subprocess import below walks every submodule and the AST scan
    every source file: both see the modules of each slice."""
    mods = set(_submodules())
    files = {str(p.relative_to(REPO)) for p in PACKAGE.rglob("*.py")}
    for name in ("lattice.dots", "lattice.orswot", "mesh.plan", "mesh.runtime",
                 "ops.cuda_gossip", "dataflow.edges", "dataflow.engine",
                 "dataflow.plan", "store.store", "bench_scenarios", "mesh.ingest",
                 "lattice.map", "bridge_state", "membership.plan",
                 "store.host_store", "store.checkpoint",
                 "telemetry.registry", "telemetry.sink", "telemetry.spans",
                 "telemetry.events", "telemetry.export", "telemetry.convergence",
                 "utils.metrics", "membership.errors", "chaos.schedule",
                 "chaos.engine", "chaos.invariants", "quorum.fsm",
                 "quorum.hints", "quorum.engine", "aae.hashtree",
                 "aae.exchange", "aae.repair", "membership.handoff",
                 "membership.coordinator", "membership.harness",
                 "serve.requests", "serve.admission", "serve.subscriptions",
                 "serve.engine", "serve.harness", "programs.base",
                 "programs.examples", "programs.riak_index", "mesh.programs",
                 "quorum.coverage", "config", "telemetry.capability",
                 "telemetry.roofline", "telemetry.device",
                 "telemetry.overhead", "api.session", "bridge.etf",
                 "bridge.server", "cli"):
        assert f"lasp_tpu_torch.{name}" in mods
        assert f"lasp_tpu_torch/{name.replace('.', '/')}.py" in files


def test_importing_every_submodule_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for name in {['lasp_tpu_torch'] + _submodules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'lasp_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PACKAGE.rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_no_forbidden_import_in_source(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def _entry_points():
    from lasp_tpu_torch import cli
    from lasp_tpu_torch.api import Session
    from lasp_tpu_torch.bench_scenarios import (
        aae_scrub,
        adcounter_6,
        adcounter_10m,
        bridge_throughput,
        chaos_heal,
        dataflow_chain,
        elastic_rebalance,
        frontier_sparse,
        gset_1k,
        ingest_storm,
        many_vars,
        orset_100k,
        orset_anti_entropy,
        packed_vs_dense,
        pipeline_1m,
        quorum_kv,
        roofline_workload,
        serve_load,
    )
    from lasp_tpu_torch.bridge import BridgeServer
    from lasp_tpu_torch.bridge_state import from_numpy
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.lattice import GSet, GSetSpec
    from lasp_tpu_torch.mesh import ReplicatedRuntime, ring
    from lasp_tpu_torch.store import Store
    from lasp_tpu_torch.store.checkpoint import load_runtime, load_store
    from lasp_tpu_torch.programs import ExampleKeylistProgram
    from lasp_tpu_torch.quorum import ring_coverage_execute
    from lasp_tpu_torch.quorum.fsm import transition_batched
    from lasp_tpu_torch.telemetry.overhead import measure_overhead

    import numpy as np

    store = Store(device="cpu")
    return {
        "Store": lambda: Store(),
        "ReplicatedRuntime": lambda: ReplicatedRuntime(
            store, Graph(store), 8, ring(8, 2)
        ),
        "orset_anti_entropy": lambda: orset_anti_entropy(16),
        "adcounter_6": lambda: adcounter_6(),
        "adcounter_10m": lambda: adcounter_10m(16),
        "gset_1k": lambda: gset_1k(),
        "orset_100k": lambda: orset_100k(16),
        "pipeline_1m": lambda: pipeline_1m(16),
        "ingest_storm": lambda: ingest_storm(16, 4, 1, 8, reps=1, gate=None),
        "dataflow_chain": lambda: dataflow_chain(3, 2, reps=1),
        "chaos_heal": lambda: chaos_heal(16),
        "quorum_kv": lambda: quorum_kv(16),
        "aae_scrub": lambda: aae_scrub(16),
        "elastic_rebalance": lambda: elastic_rebalance(),
        "serve_load": lambda: serve_load(16),
        "transition_batched": lambda: transition_batched(
            *([np.zeros(1, np.int32)] * 2 + [np.zeros((1, 3), np.int32)]
              + [np.zeros((1, 3), bool)] * 2 + [np.zeros(1, np.int32)] * 2
              + [np.zeros(1, bool), np.zeros(8, np.int32), np.ones(8, bool), 0])),
        # the device is resolved before the (absent) file is opened
        "load_store": lambda: load_store("never-opened.lasp"),
        "load_runtime": lambda: load_runtime("never-opened.lasp"),
        "codec.new": lambda: GSet.new(GSetSpec(n_elems=4)),
        "from_numpy": lambda: from_numpy(
            "lasp_gset", GSetSpec(n_elems=4), [np.zeros(4, bool)]
        ),
        # the runtime a program registers on resolves the device first
        "register": lambda: ReplicatedRuntime(
            store, Graph(store), 8, ring(8, 2)
        ).register("keys", ExampleKeylistProgram),
        "ring_coverage_execute": lambda: ring_coverage_execute(
            ReplicatedRuntime(store, Graph(store), 8, ring(8, 2))
        ),
        "measure_overhead": lambda: measure_overhead(n_replicas=8),
        "Session": lambda: Session(),
        "BridgeServer": lambda: BridgeServer(),
        "cli": lambda: cli.main(["simulate", "--replicas", "8"]),
        "bridge_throughput": lambda: bridge_throughput(8),
        "frontier_sparse": lambda: frontier_sparse(16),
        "many_vars": lambda: many_vars(16),
        "packed_vs_dense": lambda: packed_vs_dense(16),
        "roofline_workload": lambda: roofline_workload(16),
    }


@pytest.mark.parametrize("name", sorted(
    ["Store", "ReplicatedRuntime", "orset_anti_entropy", "adcounter_6",
     "adcounter_10m", "codec.new", "from_numpy", "gset_1k", "orset_100k",
     "pipeline_1m", "ingest_storm", "dataflow_chain", "load_store", "load_runtime",
     "chaos_heal", "quorum_kv", "transition_batched", "aae_scrub",
     "elastic_rebalance", "serve_load", "register", "ring_coverage_execute",
     "measure_overhead", "Session", "BridgeServer", "cli", "bridge_throughput",
     "frontier_sparse", "many_vars", "packed_vs_dense", "roofline_workload"]
))
def test_entry_points_default_to_cuda(name, monkeypatch):
    """With no CUDA, ``device=None`` raises instead of carrying on on the
    CPU (CUDA is hidden here even on a machine that has a card)."""
    entry = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_programs_and_coverage_run_on_the_cpu_when_asked():
    """``device="cpu"`` is the one way off the card: a program registers,
    takes events and answers both executes there."""
    from lasp_tpu_torch.dataflow import Graph
    from lasp_tpu_torch.mesh import ReplicatedRuntime, ring
    from lasp_tpu_torch.programs import ExampleKeylistProgram
    from lasp_tpu_torch.quorum import ring_coverage_execute
    from lasp_tpu_torch.store import Store

    store = Store(device="cpu")
    rt = ReplicatedRuntime(store, Graph(store), 8, ring(8, 2), device="cpu")
    rt.register("keys", ExampleKeylistProgram, n_elems=4)
    rt.process(("k", 1), "put", "a", replica=5)
    assert rt.execute("keys") == ring_coverage_execute(rt)["keys"] == {"k"}
    assert rt.states[rt.programs["keys"].id][0].device.type == "cpu"


def test_package_resolves_submodules_and_attributes_lazily():
    """``lasp_tpu_torch.<name>`` resolves every module a user reaches
    (``programs`` and ``config`` included) and ``Session`` / ``LaspConfig``
    / ``get_config`` as JAX's package does, without an earlier import."""
    code = (
        "import lasp_tpu_torch as L\n"
        "import sys\n"
        "assert 'lasp_tpu_torch.programs' not in sys.modules\n"
        "assert L.programs.ExampleKeylistProgram and L.config.LaspConfig\n"
        "assert L.Session is L.api.Session\n"
        "assert L.LaspConfig is L.config.LaspConfig\n"
        "assert L.get_config() is L.config.get_config()\n"
        "assert L.bridge.BridgeServer and L.cli.main\n"
        "import lasp_tpu\n"
        "missing = (sorted(lasp_tpu._SUBMODULES - L._SUBMODULES),\n"
        "           sorted(set(lasp_tpu._ATTRS) - set(L._ATTRS)))\n"
        "print(missing)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # every JAX submodule and attribute has its counterpart
    assert proc.stdout.strip() == "([], [])"
