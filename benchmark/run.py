"""Run one cell of the benchmark of ``lasp_tpu_torch`` once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: builds the cell's population through the
port's public API from the seed, warms the cell's own shapes, measures for
``--seconds`` (``--trace 1``: the same window under ``torch.profiler``,
reporting the per-layer metrics), checks what the timed path produced
against the plain reference, and prints one JSON object as the last line
of standard output; each number checked, beside its limit, ends standard
error. Exits non-zero, printing no result, without enough CUDA devices
or when the process holds JAX or the JAX package after the window."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def pin_caches() -> None:
    """Every kernel and build cache at a fixed place inside the checkout
    (the port's own CUDA libraries land in ``build/lasp_tpu_torch/``)."""
    base = CHECKOUT / "build" / "benchmark_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    pin_caches()
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from benchmark.harness import isolation, layout
    from benchmark.harness.session import run_cell

    spec = layout.load_spec()
    cell = layout.find_cell(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s), "
              f"found {found}", file=sys.stderr)
        return 2
    result, info = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START)
    held = isolation.forbidden_loaded()
    if held:
        print(f"benchmark: the process holds {held}; the port may not load them",
              file=sys.stderr)
        return 3
    for key, value in info.items():
        print(f"{key} {json.dumps(value)}", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
