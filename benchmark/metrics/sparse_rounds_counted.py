"""Layer: the frontier scheduler (``ReplicatedRuntime.frontier_step``
under ``run_to_convergence(mode="auto")``).

The share of the window's frontier rounds in which no variable crossed to
the dense arm, in %, from the program's own counters:
``gossip_frontier_rounds_total`` and ``gossip_frontier_dense_rounds_total``
(the rounds with at least one variable past the crossover). The twin of
``sparse_round_share``, which counts the same with a wrapper. Moves the
cell's end-to-end time."""

from benchmark.harness import program

NAME = "sparse_rounds_counted"
COUNTERS = ("gossip_frontier_rounds_total", "gossip_frontier_dense_rounds_total")


def install(ctx) -> None:
    if program.require(NAME, COUNTERS[1]):
        ctx.own[NAME] = program.counters_now(COUNTERS)


def read(ctx):
    before = ctx.own.get(NAME)
    if before is None:
        return None
    rounds = program.moved(before, COUNTERS[0])
    dense = program.moved(before, COUNTERS[1])
    if rounds <= 0:
        raise RuntimeError(f"{NAME}: {COUNTERS[0]} did not move in the window")
    return 100.0 * (rounds - dense) / rounds
