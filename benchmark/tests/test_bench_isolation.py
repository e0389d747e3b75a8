"""Isolation: a run holds neither JAX nor the JAX package, compared by
whole top-level module names, and the references load nothing of the
port."""

from __future__ import annotations

import subprocess
import sys

from benchmark.harness import isolation
from benchmark.harness.layout import CHECKOUT


def test_names_are_compared_whole():
    assert isolation.forbidden_loaded(["lasp_tpu_torch", "lasp_tpu_torch.mesh",
                                       "jaxtyping", "flaxen"]) == []
    assert isolation.forbidden_loaded(["lasp_tpu.mesh", "jax._src", "jaxlib",
                                       "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                          "lasp_tpu"]


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=300, check=True)
    return {m.split(".", 1)[0] for m in out.stdout.split()}


def test_a_run_loads_no_jax():
    code = (
        "import sys, time, torch\n"
        "sys.path.insert(0, '.')\n"
        "from benchmark.tests.conftest import run_tiny\n"
        "assert run_tiny('kvs-zipf-burst', seconds=0.5)['correct']\n"
        "assert run_tiny('adcounter-converge', seconds=0.5)['correct']\n"
    )
    tops = _modules_after(code)
    assert "lasp_tpu_torch" in tops
    assert not tops & isolation.FORBIDDEN


def test_references_load_nothing_of_the_port():
    code = (
        "import sys\n"
        "sys.path.insert(0, '.')\n"
        "import benchmark.reference.kvs, benchmark.reference.adcounter\n"
    )
    tops = _modules_after(code)
    assert not tops & (isolation.FORBIDDEN | {"lasp_tpu_torch", "torch"})
