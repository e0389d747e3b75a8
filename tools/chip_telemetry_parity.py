"""The telemetry parity part of chip_smoke.py's telemetry phase alone, on
one card: build the kernels, then at each replica count run the parity
drive on the card and its CPU twin through the plain versions
(``chip_smoke._telemetry_parity``: transcripts equal, K1 / K2 / K3
launched, each widest call held against its plain version), then
``measure_overhead`` once. Prints each part's line with the card's name and
power limit; the CPU twin's seconds by replica count set
``chip_smoke._PARITY_REPLICAS``.

    python3 tools/chip_telemetry_parity.py [2048,4096]
"""
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from lasp_tpu_torch.ops import _build  # noqa: E402
from lasp_tpu_torch.ops import cuda_gossip as cg  # noqa: E402
from lasp_tpu_torch.telemetry.overhead import measure_overhead  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_telemetry_parity: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    cs._CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cs._log("build", f"{len(_build.SOURCES)} kernels built in {_build.build_all():.2f} s")
    sizes = sys.argv[1] if len(sys.argv) > 1 else "2048,4096"
    for n in map(int, sizes.split(",")):
        cs._PARITY_REPLICAS = n
        t0 = time.perf_counter()
        line = cs._telemetry_parity(torch, cg)
        cs._log_line("telemetry", {**line, "part_seconds": time.perf_counter() - t0})
    over = measure_overhead()
    cs._log_line("telemetry", {"part": "overhead", "step_overhead_frac": over["overhead_frac"],
                               "dataflow": over["dataflow"]})
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
