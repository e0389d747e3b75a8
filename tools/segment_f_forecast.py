"""Forecast of chip_smoke.py's segment (f) on the CPU, before a chip run:
the drive's rounds on one process, each with the arm two ranks would take
(``rt._frontier_dense_arm``: sparse while every variable's reach stays under
the crossover) and, for a sparse round, the bytes each rank's
``all_to_all`` would carry (the rows of its run that the other rank's
reachable rows read, times the row bytes). A dense gather round carries a
rank's whole run. The wide OR-SWOT (A=E=64, 1.66 GB at 100,000 rows) is
left out of the population; its frontier is taken to be the narrow
OR-SWOT's, and its row bytes come from a 16-row runtime. Counts and bytes
only: no time.

    python3 tools/segment_f_forecast.py [n_replicas]
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from lasp_tpu_torch.mesh import random_regular  # noqa: E402


def main(n: int) -> None:
    import lasp_tpu_torch.device as device

    def cpu(device=None):
        return torch.device("cpu" if device is None else device)

    device.resolve_device.__code__ = cpu.__code__  # the drive builds on the CPU
    torch.cuda.synchronize = lambda *a, **k: None
    one, *_ = cs._engine(torch, 16, random_regular(16, 3, seed=0),
                         orswots=(("narrow", 8, 4), ("wide", 64, 64)))
    row_bytes = {v: one._row_bytes(v) for v in one.var_ids}
    rt, *_ = cs._engine(torch, n, random_regular(n, 3, seed=0), orswots=(("narrow", 8, 4),))
    weight = dict(row_bytes, narrow=row_bytes["narrow"] + row_bytes["wide"])
    runs = ((0, n - n // 2), (n - n // 2, n))
    rng = np.random.RandomState(31)

    def sparse_bytes():
        sent = [0] * len(runs)
        nb = rt._host_neighbors
        for v in rt.var_ids:
            reach = np.flatnonzero(rt._frontier[v][nb].any(axis=1))
            for me, (lo, hi) in enumerate(runs):
                read = np.unique(nb[reach[(reach < lo) | (reach >= hi)]])
                sent[me] += int(((read >= lo) & (read < hi)).sum()) * weight[v]
        return sent

    def one_round(stage):
        hot = rt._frontier_dense_arm(None)
        reach = max(int(rt._frontier[v][rt._host_neighbors].any(axis=1).sum())
                    for v in rt.var_ids)
        rec = {"stage": stage, "arm": "dense" if hot else "sparse", "max_reach": reach,
               "sent_bytes_by_rank": (sparse_bytes() if hot is None else
                                      [(hi - lo) * sum(row_bytes.values()) for lo, hi in runs])}
        rec["residual"] = rt.frontier_step()
        print(json.dumps(rec), flush=True)
        return rec["residual"]

    print(json.dumps({"n_replicas": n, "row_bytes": row_bytes,
                      "crossover_rows": rt.frontier_crossover * n}), flush=True)
    cs._frontier_writes(rt, rng, cs._FRONTIER_F["writes"])
    while rt._frontier_dense_arm(None) is None:
        if not one_round("explicit"):
            break
    for stage, k in (("auto", 0), ("auto_2pct", int(cs._FRONTIER_F["share"] * n))):
        if k:
            cs._frontier_writes(rt, rng, k)
        while one_round(stage):
            pass


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else cs._FRONTIER_F["n_replicas"])
