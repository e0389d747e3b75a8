"""The result line of each cell, run on the CPU at tiny sizes: its keys,
its metrics as ``BENCHMARK.json`` names them, and the check last."""

from __future__ import annotations

import json

import pytest

from benchmark.harness import layout

from .conftest import CELLS, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_line(workload):
    spec = layout.load_spec()
    cell = layout.find_cell(spec, workload)
    res = run_tiny(workload)
    json.dumps(res)
    assert list(res)[:5] == KEYS and list(res)[-1] == "check"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"]: m["unit"] for m in layout.end_to_end_of(spec, cell)}
    assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert all(c["value"] <= c["limit"] for c in res["check"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_traced_line(workload):
    spec = layout.load_spec()
    cell = layout.find_cell(spec, workload)
    res = run_tiny(workload, trace=True)
    assert res["correct"] is True
    names = {m["name"] for m in layout.per_layer_of(spec, cell)}
    # the CPU runs no kernel: only the readers of host counters and spans
    # find something
    assert set(res["metrics"]) <= names
    host_read = {n for n in names if n.split(".")[0] in
                 ("noop_round_share", "ingest_ms_per_kop", "sparse_round_share",
                  "read_ms_per_kop")}
    assert host_read <= set(res["metrics"])
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "check"


def test_every_metric_has_a_reader_and_every_cell_reports_what_it_needs():
    spec = layout.load_spec()
    for m in spec["per_layer"]:
        assert hasattr(layout.metric_module(m["name"]), "read"), m["name"]
    for cell in spec["workloads"]:
        e2e = {m["name"] for m in layout.end_to_end_of(spec, cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = layout.per_layer_of(spec, cell)
        assert per and all(m["moves"] in e2e for m in per)
