"""Layer: the frontier scheduler (``ReplicatedRuntime.frontier_step``
under ``run_to_convergence(mode="auto")``).

The share of the window's frontier rounds in which no variable crossed to
the dense arm, in %: after each ``frontier_step`` the harness's wrapper
reads ``frontier_dense_falls_last``, the variables that round sent past
the crossover (a runtime without either fails the run). Moves the cell's end-to-end time."""

NAME = "sparse_round_share"


def install(ctx) -> None:
    rt = ctx.rt
    inner = getattr(rt, "frontier_step", None)
    if inner is None or not hasattr(rt, "frontier_dense_falls_last"):
        raise AttributeError("sparse_round_share: the runtime has no frontier_step "
                             "or frontier_dense_falls_last; the metric would fall "
                             "silent")
    seen = ctx.own[NAME] = {"rounds": 0, "sparse": 0}

    def counted(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen["rounds"] += 1
        seen["sparse"] += int(rt.frontier_dense_falls_last == 0)
        return out

    rt.frontier_step = counted


def read(ctx):
    seen = ctx.own.get(NAME)
    if not seen or seen["rounds"] <= 0:
        return None
    return 100.0 * seen["sparse"] / seen["rounds"]
