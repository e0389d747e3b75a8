"""Fixtures of the benchmark's CPU tests: tiny copies of each cell's
configuration and mix, and the ``cuda`` marker for the tests that need
the card (they skip inside a fixture where there is none).

    python -m pytest -q benchmark/tests
"""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[2]
# a few test workers share the host: keep each to two threads
torch.set_num_threads(2)
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from benchmark.harness import layout  # noqa: E402
from benchmark.harness.session import run_cell  # noqa: E402

#: the tiny sizes a CPU test runs each configuration and mix at
TINY_CONFIG = {"adcounter": {"n_replicas": 4096},
               "kvs": {"n_replicas": 2000, "recordcount": 20}}
TINY_MIX = {"replay": {}, "burst": {"operationcount": 200}}
CELLS = ("adcounter-converge", "kvs-zipf-burst")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips in a fixture where there is none)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    return torch.device("cuda")


def tiny(spec: dict, workload: str) -> tuple:
    """``(cell, config, mix)`` of a workload, cut to a CPU test's size."""
    cell = layout.find_cell(spec, workload)
    config = copy.deepcopy(layout.config_of(spec, cell))
    config.update(TINY_CONFIG[config["app"]])
    mix = copy.deepcopy(layout.traffic_of(cell))
    mix.update(TINY_MIX[mix["driver"]])
    return cell, config, mix


def run_tiny(workload: str, seed: int = 2**31 + 7, seconds: float = 1.5,
             trace: bool = False, faults=(), spec=None) -> dict:
    spec = spec if spec is not None else layout.load_spec()
    cell, config, mix = tiny(spec, workload)
    result, _parts = run_cell(spec, cell, seed, seconds, trace, torch.device("cpu"),
                              time.perf_counter(), config=config, mix=mix,
                              faults=faults)
    return result
