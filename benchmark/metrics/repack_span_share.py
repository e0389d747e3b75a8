"""Layer: the packed OR-Set codec (``lasp_tpu_torch.ops.packed``:
``pack_bits`` and ``unpack_bits``).

The device time of the kernels launched inside the program's ``packed.pack``
and ``packed.unpack`` ranges, over the device's busy time in the timed
ranges, in %, from the profiler's trace. The twin of ``repack_share``,
which ranges the same functions with a wrapper. Moves ``converge_s``."""

from benchmark.harness import program

NAME = "repack_span_share"
SPANS = ("packed.pack", "packed.unpack")


def install(ctx) -> None:
    if program.require(NAME, *SPANS):
        ctx.own[NAME] = True


def read(ctx):
    trace = ctx.trace
    if not ctx.own.get(NAME) or trace is None or trace.busy_s <= 0:
        return None
    if not any(program.timed_spans(trace, s) for s in SPANS):
        raise RuntimeError(f"{NAME}: the traced window holds no packed.* span")
    return 100.0 * program.device_seconds_launched(trace, ("packed.",)) / trace.busy_s
