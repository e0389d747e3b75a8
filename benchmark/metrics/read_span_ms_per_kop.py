"""Layer: the read path (``ReplicatedRuntime.replica_value``).

Milliseconds of the program's ``mesh.replica_value`` spans per 1,000 of
them (a read of one record at one replica each), on the profiler's clock
(traced runs only). Moves the cell's end-to-end time."""

from benchmark.harness import program

NAME = "read_span_ms_per_kop"
SPAN = "mesh.replica_value"


def install(ctx) -> None:
    if program.require(NAME, SPAN):
        ctx.own[NAME] = True


def read(ctx):
    if not ctx.own.get(NAME) or ctx.trace is None:
        return None
    spans = program.spans_or_raise(NAME, ctx.trace, SPAN)
    return 1e6 * program.seconds(spans) / len(spans)
