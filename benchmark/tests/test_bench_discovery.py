"""A cell, a traffic mix and a per-layer metric added as files and
entries alone are picked up, with no edit to a file of the harness."""

from __future__ import annotations

import json
import shutil

from benchmark.harness import layout

from .conftest import run_tiny


def test_new_cell_mix_and_metric_by_files_alone(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(layout.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = layout.load_spec()
    # a new mix: YCSB workload B's proportions (95% reads)
    mix = json.loads((layout.HERE / "traffic" / "ycsb-a-burst.json").read_text())
    mix.update(readproportion=0.95, updateproportion=0.05)
    (root / "benchmark" / "traffic" / "ycsb-b-burst.json").write_text(json.dumps(mix))
    # a new per-layer metric: rounds a convergence, from the driver's records
    (root / "benchmark" / "metrics" / "rounds_per_converge.py").write_text(
        "def read(ctx):\n"
        "    r = ctx.driver.records.rounds\n"
        "    return sum(r) / len(r) if r else None\n")
    spec["workloads"].append({"name": "kvs-ycsb-b", "config": "kvs-orset-100k",
                              "traffic": "ycsb-b-burst", "chips": 1,
                              "why": "a test cell"})
    spec["per_layer"].append({"name": "rounds_per_converge.small", "unit": "rounds",
                              "better": "lower", "source": "program_counter",
                              "layer": "converge loop", "moves": "burst_s",
                              "workloads": ["kvs-ycsb-b"]})
    burst = next(m for m in spec["end_to_end"] if m["name"] == "burst_s")
    burst["workloads"].append("kvs-ycsb-b")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(layout, "HERE", root / "benchmark")
    monkeypatch.setattr(layout, "CHECKOUT", root)
    spec = layout.load_spec()
    assert layout.find_cell(spec, "kvs-ycsb-b")["traffic"] == "ycsb-b-burst"
    plain = run_tiny("kvs-ycsb-b", spec=spec)
    assert set(plain["metrics"]) == {"setup_s", "burst_s"}
    traced = run_tiny("kvs-ycsb-b", spec=spec, trace=True)
    assert traced["metrics"]["rounds_per_converge.small"]["value"] > 0
    assert traced["correct"] is True
