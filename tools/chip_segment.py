"""One gather-path segment of chip_smoke.py's distributed phase alone, on
one card: build the kernels, spawn two gloo ranks on the card that run the
segment's worker, compute its one-process twins here meanwhile and hold
each rank against them. Segment ``e`` is membership, Lasp's programs and
``Session`` (``_membership_worker``, ``_check_membership_e``), segment
``f`` the sparse frontier (``_frontier_worker``, ``_check_frontier_f``).
Each rank's record goes to ``chiprun_out/<segment>_only/``.

    python3 tools/chip_segment.py e|f
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: segment -> (the rank's worker, the parent's twins, the check)
SEGMENTS = {
    "e": (lambda torch, cg, mesh: cs._membership_worker(torch, cg, mesh),
          lambda torch: cs._membership_parts(torch, lambda rt: rt), cs._check_membership_e),
    "f": (lambda torch, cg, mesh: cs._frontier_worker(torch, cg, mesh),
          lambda torch: cs._frontier_f(torch, lambda rt: rt), cs._check_frontier_f),
}


def worker(seg, out_dir):
    import torch

    from lasp_tpu_torch.device import resolve_device
    from lasp_tpu_torch.mesh import comm
    from lasp_tpu_torch.ops import cuda_gossip as cg

    assert comm.init_distributed()
    rank, dev = comm.process_index(), resolve_device(None)
    mesh = comm.build_mesh(devices=comm.global_slots(4, device=dev),
                           slice_of=lambda s: s.process_index)
    t0 = time.perf_counter()
    res = SEGMENTS[seg][0](torch, cg, mesh)
    res["wall_s"] = time.perf_counter() - t0
    res["carried_bytes"] = {k: e["bytes"] for k, e in comm.CARRIED.items()}
    res["stage_s"] = dict(comm.STAGE_S)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res, default=str))
    torch.distributed.destroy_process_group()


def main(seg):
    import torch

    from lasp_tpu_torch.ops import _build

    _worker, twins_of, check = SEGMENTS[seg]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    print("build", _build.build_all(), flush=True)
    out_dir = str(ROOT / "chiprun_out" / f"{seg}_only")
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(cs._free_port()),
               WORLD_SIZE="2", LOCAL_WORLD_SIZE="2")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", seg, out_dir],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        tt = time.perf_counter()
        twins = twins_of(torch)
        twins["seconds"]["all"] = time.perf_counter() - tt
        twins = json.loads(json.dumps(twins, default=str))
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    secs = time.perf_counter() - t0
    for r, (_out, err) in enumerate(outs):
        Path(out_dir, f"rank{r}.stderr").write_text(err)
        print(f"rank {r} rc={procs[r].returncode} stderr tail:\n{err[-2500:]}", flush=True)
    Path(out_dir, "twins.json").write_text(json.dumps(twins))
    for r in range(2):
        got = json.loads(Path(out_dir, f"rank{r}.json").read_text())
        check(r, got, twins)
        print(json.dumps({k: v for k, v in got.items()
                          if k not in ("hashes", "residuals", "values")}), flush=True)
    print(json.dumps({"phase_s": secs, "twins_s": twins["seconds"]}), flush=True)
    print(f"{seg.upper()}-ONLY OK", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3])
    else:
        main(sys.argv[1])
