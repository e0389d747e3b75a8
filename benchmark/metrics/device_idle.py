"""Layer: the device (one H100).

The share of the timed ranges in which no kernel, copy or fill ran on the
card, in %, from the profiler's trace. Moves the cell's end-to-end
time."""


def read(ctx):
    trace = ctx.trace
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
