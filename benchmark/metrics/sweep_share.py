"""Layer: the dataflow graph and trigger (``ReplicatedRuntime._local_round``:
the graph's round and the triggers over every replica's rows).

The device time of the kernels launched inside the program's
``dataflow.sweep`` span and outside its ``packed.*`` ranges (the repack,
which ``repack_span_share`` reads), over the device's busy time in the
timed ranges, in %, from the profiler's trace. Moves ``converge_s``."""

from benchmark.harness import program

NAME = "sweep_share"
SPAN = "dataflow.sweep"


def install(ctx) -> None:
    if program.require(NAME, SPAN, "packed.pack", "packed.unpack"):
        ctx.own[NAME] = True


def read(ctx):
    trace = ctx.trace
    if not ctx.own.get(NAME) or trace is None or trace.busy_s <= 0:
        return None
    program.spans_or_raise(NAME, trace, SPAN)
    swept = program.device_seconds_launched(trace, (SPAN,), besides=("packed.",))
    return 100.0 * swept / trace.busy_s
