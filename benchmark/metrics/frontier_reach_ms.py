"""Layer: the frontier scheduler (``ReplicatedRuntime.frontier_step``).

Milliseconds a frontier round spends in its ``frontier.reach`` spans (the
reverse-neighbour reachability of each dirty variable, on the host),
over the window's ``gossip.frontier_round`` spans, on the profiler's clock
(traced runs only). Moves the cell's end-to-end time."""

from benchmark.harness import program

NAME = "frontier_reach_ms"
ROUND, REACH = "gossip.frontier_round", "frontier.reach"


def install(ctx) -> None:
    if program.require(NAME, REACH):
        ctx.own[NAME] = True


def read(ctx):
    trace = ctx.trace
    if not ctx.own.get(NAME) or trace is None:
        return None
    rounds = program.spans_or_raise(NAME, trace, ROUND)
    reach = program.spans_or_raise(NAME, trace, REACH)
    return 1e3 * program.seconds(reach) / len(rounds)
