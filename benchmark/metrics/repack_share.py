"""Layer: the packed OR-Set codec (``lasp_tpu_torch.ops.packed``,
``ops.flatpack``).

The device time of the kernels that ``pack_bits`` and ``unpack_bits``
launch, over the device's busy time in the timed ranges, in %. The
harness wraps both functions (in both modules that call them) in a
``bench.repack`` range for the window and reads the kernels under those
ranges through the profiler's launch links, whatever PyTorch names them
(``reduce_kernel``, the elementwise and copy kernels); a port without
either function fails the run. Moves
``converge_s``."""

import torch

NAME = "repack_share"
RANGE = "bench.repack"
FUNCTIONS = ("pack_bits", "unpack_bits")


def _ranged(fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(RANGE):
            return fn(*args, **kwargs)
    return wrapped


def install(ctx) -> None:
    from lasp_tpu_torch.ops import flatpack, packed

    for name in FUNCTIONS:
        holders = [mod for mod in (flatpack, packed) if hasattr(mod, name)]
        if not holders:
            raise AttributeError(f"repack_share: the port has no {name} to range; "
                                 "the metric would fall silent")
        for mod in holders:
            setattr(mod, name, _ranged(getattr(mod, name)))
    ctx.own[NAME] = True


def read(ctx):
    trace = ctx.trace
    if trace is None or not ctx.own.get(NAME) or trace.busy_s <= 0:
        return None
    repack = trace.annotated_device_seconds(RANGE)
    if repack <= 0:
        return None
    return 100.0 * repack / trace.busy_s
