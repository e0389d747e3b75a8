"""Where a cell's files are: everything is found by the names in
``BENCHMARK.json``, so a later cell, mix or metric is a new file and a new
entry, never an edit."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

#: the benchmark's own folder and the checkout that holds it
HERE = Path(__file__).resolve().parents[1]
CHECKOUT = HERE.parent


def load_spec(path: "Path | None" = None) -> dict:
    return json.loads((path or CHECKOUT / "BENCHMARK.json").read_text())


def find_cell(spec: dict, workload: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return cell
    names = [c["name"] for c in spec["workloads"]]
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {names})")


def config_of(spec: dict, cell: dict) -> dict:
    """The cell's configuration: its file under ``configs/``, read as it
    is run."""
    for entry in spec["configs"]:
        if entry["name"] == cell["config"]:
            return json.loads((CHECKOUT / entry["file"]).read_text())
    raise KeyError(f"no configuration {cell['config']!r} in BENCHMARK.json")


def traffic_of(cell: dict) -> dict:
    return json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())


def load_module(path: Path, name: str):
    """Import one file of the benchmark by path (its name may hold dots or
    dashes), once per process."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def app_module(config: dict):
    return load_module(HERE / "apps" / f"{config['app']}.py",
                       f"benchmark_app_{config['app']}")


def reference_module(config: dict):
    return load_module(HERE / "reference" / f"{config['reference']}.py",
                       f"benchmark_reference_{config['reference']}")


def metric_path(name: str) -> Path:
    """``metrics/<name>.py``, else ``metrics/<base>.py`` for a name
    ``<base>.<cell>``: one reader serves the cells a metric is split over."""
    whole = HERE / "metrics" / f"{name}.py"
    if whole.exists():
        return whole
    return HERE / "metrics" / f"{name.split('.', 1)[0]}.py"


def metric_module(name: str):
    path = metric_path(name)
    return load_module(path, "benchmark_metric_" + path.stem.replace(".", "_"))


def per_layer_of(spec: dict, cell: dict) -> list:
    """The per-layer metrics that this cell reports: those that list it,
    and those without a ``workloads`` key whose end-to-end metric the cell
    reports."""
    e2e = {m["name"] for m in end_to_end_of(spec, cell)}
    out = []
    for m in spec["per_layer"]:
        cells = m.get("workloads")
        if (cells is not None and cell["name"] in cells) or (
            cells is None and m["moves"] in e2e
        ):
            out.append(m)
    return out


def end_to_end_of(spec: dict, cell: dict) -> list:
    return [m for m in spec["end_to_end"]
            if "workloads" not in m or cell["name"] in m["workloads"]]
