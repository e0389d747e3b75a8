"""Run a cell with a fault planted in its timed path (``harness.faults``),
once for each of several seeds, in one process, on the card, and print
each run's checked numbers. The benchmark's own runs never run it: it
reads the control's numbers (``--fault early_answer``) and the faults'
that the limits of ``correct`` are set against.

    python3 benchmark/tools/control.py --workload <name> --fault <fault> \\
        --seeds 1,2,3 --seconds 3
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", default="")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from benchmark.harness import layout
    from benchmark.harness.faults import FAULTS
    from benchmark.harness.session import run_cell

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    spec = layout.load_spec()
    cell = layout.find_cell(spec, args.workload)
    faults = [FAULTS[args.fault]] if args.fault else []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, _parts = run_cell(spec, cell, seed, args.seconds, False,
                                  torch.device("cuda", 0), t0, faults=faults)
        print(json.dumps({"workload": args.workload, "fault": args.fault or None,
                          "seed": seed, "correct": result["correct"],
                          "check": result["check"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del result
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
