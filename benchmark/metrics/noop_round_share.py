"""Layer: the converge loop (``ReplicatedRuntime.converge_on_device``).

The share of the gossip rounds the loop ran past the exact count each
convergence returns, in %. The harness counts the rounds run with a
wrapper around ``ReplicatedRuntime._dense_round`` for the window (a
runtime without it fails the run, rather than leave the metric out); the
exact rounds (the final quiescent round included, the count a loop that
stopped there would run) are each convergence's return value. Moves
``converge_s``."""

NAME = "noop_round_share"


def install(ctx) -> None:
    rt = ctx.rt
    inner = getattr(rt, "_dense_round", None)
    if inner is None:
        raise AttributeError("noop_round_share: the runtime has no _dense_round "
                             "to count; the metric would fall silent")
    seen = ctx.own[NAME] = {"rounds": 0}

    def counted(*args, **kwargs):
        seen["rounds"] += 1
        return inner(*args, **kwargs)

    rt._dense_round = counted


def read(ctx):
    seen = ctx.own.get(NAME)
    ran = seen["rounds"] if seen else 0
    exact = sum(ctx.driver.records.rounds)
    if ran <= 0 or exact <= 0:
        return None
    return 100.0 * max(ran - exact, 0) / ran
