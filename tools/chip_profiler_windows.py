"""The one-kernel profiler check of chip_smoke.py on a fresh process, on one
card: build the kernels, run the ``plan`` phase (its K2 / K3 shapes and their
captured inputs), then ``_one_kernel_per_call`` over those shapes, first on
their own and then with all but 512, 64 or 8 MiB of the card held by the
caching allocator (free to PyTorch, not to the profiler), each time also with
``torch.cuda.empty_cache()`` before every window. Prints, per run, the
kernels each window showed (-1: no marker record) and what the first
windows recorded.

    python3 tools/chip_profiler_windows.py
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ORIG = cs._device_kernels
DIAGS = []


def wrapped(empty):
    """``_device_kernels`` with its window record kept in ``DIAGS``, after
    ``torch.cuda.empty_cache()`` when ``empty``."""
    def dk(torch, warm, calls, diag=None):
        if empty:
            torch.cuda.empty_cache()
        d = {} if diag is None else diag
        out = ORIG(torch, warm, calls, d)
        DIAGS.append({k: d.get(k) for k in ("device_records", "markers", "marker_lag_us")})
        return out
    return dk


def main():
    import torch

    from lasp_tpu_torch.ops import _build
    from lasp_tpu_torch.ops import cuda_gossip as cg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    print("build", _build.build_all(), flush=True)
    captured = {}
    plan = cs.phase_plan(torch, cg, 100_000, captured)
    shapes = {name: {k: c for k, c in plan["shapes"][name].items()
                     if (name, k) in captured}
              for name in ("gossip_round_rows", "gossip_round_rows_vclock")}
    sources = {"plan": plan["rt"]}

    def run(tag, empty):
        cs._device_kernels = wrapped(empty)
        DIAGS.clear()
        prof = {n: {} for n in shapes}
        err = None
        t0 = time.perf_counter()
        try:
            cs._one_kernel_per_call(torch, cg, shapes, captured, sources, prof)
        except RuntimeError as exc:
            err = str(exc)[:200]
        free, _total = torch.cuda.mem_get_info()
        print(tag, f"{time.perf_counter() - t0:.2f} s",
              {n: prof[n].get("profiled_windows_counts") for n in prof}, err,
              f"free {free / 2**20:.0f} MiB reserved "
              f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB", DIAGS[:6], flush=True)

    run("plain", False)
    for leave_mib in (512, 64, 8):
        torch.cuda.empty_cache()
        free, _total = torch.cuda.mem_get_info()
        x = torch.empty(free - leave_mib * 2**20, dtype=torch.uint8, device="cuda")
        del x  # held by the caching allocator, free to PyTorch only
        run(f"held, {leave_mib} MiB left", False)
        run(f"held, {leave_mib} MiB left, empty_cache a window", True)
    torch.cuda.empty_cache()
    run("plain again", False)


if __name__ == "__main__":
    main()
