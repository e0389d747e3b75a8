"""Layer: the frontier scheduler (``ReplicatedRuntime.frontier_step``).

Milliseconds of a frontier round's host work: each ``gossip.frontier_round``
span less the ``frontier.dispatch`` spans inside it (a launch, from its row
matrix to its host sync), averaged over the window's rounds, on the
profiler's clock (traced runs only, so the profiler's host cost is in it).
Moves the cell's end-to-end time."""

from benchmark.harness import program

NAME = "frontier_host_ms"
ROUND, DISPATCH = "gossip.frontier_round", "frontier.dispatch"


def install(ctx) -> None:
    if program.require(NAME, DISPATCH):
        ctx.own[NAME] = True


def read(ctx):
    trace = ctx.trace
    if not ctx.own.get(NAME) or trace is None:
        return None
    rounds = program.spans_or_raise(NAME, trace, ROUND)
    dispatched = program.inside(program.timed_spans(trace, DISPATCH), rounds)
    return (sum(b - a for a, b in rounds) - dispatched) / 1e3 / len(rounds)
