"""Layer: the converge loop (``ReplicatedRuntime.converge_on_device``).

The share of the gossip rounds the loop ran past the exact count, in %,
from the program's own counters over the window: ``gossip_rounds_run_total``
(every round run, the no-op rounds of a block after the fixed point
included) against ``gossip_rounds_total`` (the exact rounds). The twin of
``noop_round_share``, which counts the same with a wrapper. Moves
``converge_s``."""

from benchmark.harness import program

NAME = "noop_rounds_counted"
COUNTERS = ("gossip_rounds_run_total", "gossip_rounds_total")


def install(ctx) -> None:
    if program.require(NAME, COUNTERS[0]):
        ctx.own[NAME] = program.counters_now(COUNTERS)


def read(ctx):
    before = ctx.own.get(NAME)
    if before is None:
        return None
    ran = program.moved(before, COUNTERS[0])
    exact = program.moved(before, COUNTERS[1])
    if ran <= 0:
        raise RuntimeError(f"{NAME}: {COUNTERS[0]} did not move in the window")
    return 100.0 * (ran - exact) / ran
