#!/usr/bin/env python3
"""Whether NCCL takes two ranks of one process group on one card: the
rule of ``lasp_tpu_torch.mesh.comm.choose_backend`` (gloo when ranks share
a card) rests on its answer.

    python3 tools/torch_nccl_shared_card.py

Spawns two ranks on ``cuda:0`` that join with the ``nccl`` backend and
run one ``all_reduce``; prints each rank's outcome (the error text, or the
reduced value) and the tail of its stderr (``NCCL_DEBUG=WARN``), then the
card's name and power limit. Exits 0 whatever NCCL answers, and non-zero
when there is no card or a rank hangs past its timeout."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

TIMEOUT_S = 120


def worker() -> int:
    import torch
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    torch.cuda.set_device(0)
    try:
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
            world_size=2, rank=rank)
        x = torch.full((4,), float(rank + 1), device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        out = {"rank": rank, "ok": True, "value": x.tolist()}
    except Exception as exc:  # noqa: BLE001 — the answer this script reports
        out = {"rank": rank, "ok": False, "error": f"{type(exc).__name__}: {exc}"}
    print(json.dumps(out), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_nccl_shared_card: no card", file=sys.stderr)
        return 2
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, MASTER_PORT=str(port), NCCL_DEBUG="WARN")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank"],
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    rc = 0
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            print(f"rank {r}: hung past {TIMEOUT_S} s")
            rc = 1
        print(f"rank {r} (exit {p.returncode}): {out.strip()}")
        print(f"rank {r} stderr tail: {err[-1500:]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), f"| torch {torch.__version__} cuda {torch.version.cuda} "
          f"nccl {'.'.join(map(str, torch.cuda.nccl.version()))}")
    return rc


if __name__ == "__main__":
    sys.exit(worker() if sys.argv[1:2] == ["--rank"] else main())
