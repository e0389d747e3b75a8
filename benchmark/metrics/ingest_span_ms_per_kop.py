"""Layer: the write path (``ReplicatedRuntime.ingest_cycle``).

Milliseconds of the program's ``mesh.ingest_cycle`` spans per 1,000 ops,
the ops counted by the program's ``ingest_cycle_ops_total`` (every op a
cycle takes into a batch, both arms; a field update is a remove and an
add), on the profiler's clock (traced runs only). Unlike
``ingest_ms_per_kop`` it leaves out the device work still queued when the
call returns. Moves the cell's end-to-end time."""

from benchmark.harness import program

NAME = "ingest_span_ms_per_kop"
SPAN, COUNTER = "mesh.ingest_cycle", "ingest_cycle_ops_total"


def install(ctx) -> None:
    if program.require(NAME, SPAN, COUNTER):
        ctx.own[NAME] = program.counters_now((COUNTER,))


def read(ctx):
    before = ctx.own.get(NAME)
    if before is None or ctx.trace is None:
        return None
    ops = program.moved(before, COUNTER)
    if ops <= 0:
        raise RuntimeError(f"{NAME}: {COUNTER} did not move in the window")
    spans = program.spans_or_raise(NAME, ctx.trace, SPAN)
    return 1e6 * program.seconds(spans) / ops
