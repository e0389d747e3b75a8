"""The kernels' bytes from their launch shapes, and the card's peaks.

The shapes are the port's own records of each launch
(``lasp_tpu_torch.ops.cuda_gossip.SHAPES``, keyed by ``SHAPE_FIELDS``).
Each input is counted read once and each output written once, whatever
the kernel reads again. K2 and K3 gather the rows of a sparse frontier:
the targets' own rows, the joined rows, the index entries and the flags
are counted, and the neighbours' rows are not, since how many distinct
rows they are depends on the data and not on the shape; their share is a
floor, never above the truth."""

from __future__ import annotations

#: HBM bandwidth by the name ``torch.cuda.get_device_name()`` gives:
#: NVIDIA's data sheet for the H100 SXM5 80 GB (3.35 TB/s at its 700 W
#: limit), the peak ``lasp_tpu_torch.telemetry.capability`` states
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

_ITEM = {"bool": 1, "uint8": 1, "int8": 1, "int16": 2, "int32": 4,
         "float32": 4, "int64": 8, "float64": 8}

#: the fields of each kernel's shape key (``cuda_gossip.SHAPE_FIELDS``)
FIELDS = {
    "gossip_round_dense": ("R", "D", "K", "slab_words", "S"),
    "gossip_round_rows": ("G", "F", "R", "width", "leaves", "K", "dtype",
                          "op", "masked", "vec_bytes", "team_lanes"),
    "gossip_round_rows_vclock": ("G", "F", "R", "A", "E", "K", "masked",
                                 "bulk", "chunk_words"),
}

#: a substring of each kernel's symbol as the profiler names it
SYMBOL = {
    "gossip_round_dense": "gossip_round_dense_kernel",
    "gossip_round_rows": "gossip_round_rows_kernel",
    "gossip_round_rows_vclock": "gossip_round_rows_vclock_kernel",
}


def dense_bytes(s: dict) -> int:
    """K1: both ``int32[S, D]`` planes read, both ``[R, D]`` planes
    written, the ``int32[R, K]`` table read."""
    return 2 * 4 * s["D"] * (s["S"] + s["R"]) + 4 * s["R"] * s["K"]


def _sparse_slot(s: dict, row_bytes: int) -> int:
    # own row in, joined row out, the changed flag, the row index (int32
    # at least), K table entries, K mask bytes when masked
    return 2 * row_bytes + 1 + 4 + 4 * s["K"] + s["K"] * int(s["masked"])


def rows_bytes(s: dict) -> int:
    """K2 over ``G x F`` slots of ``leaves`` leaves of ``width`` items."""
    row = s["leaves"] * s["width"] * _ITEM[s["dtype"]]
    return s["G"] * s["F"] * _sparse_slot(s, row)


def vclock_bytes(s: dict) -> int:
    """K3 over ``G x F`` slots of an ``int32[A]`` clock and ``int32[E, A]``
    dots."""
    row = 4 * (s["A"] + s["E"] * s["A"])
    return s["G"] * s["F"] * _sparse_slot(s, row)


BYTES = {
    "gossip_round_dense": dense_bytes,
    "gossip_round_rows": rows_bytes,
    "gossip_round_rows_vclock": vclock_bytes,
}


def launched_bytes(kernel: str, shapes: dict) -> int:
    """The bytes of every launch counted in ``shapes`` (``{shape key:
    launches}``)."""
    fn = BYTES[kernel]
    return sum(n * fn(dict(zip(FIELDS[kernel], key))) for key, n in shapes.items())


def share(kernels, shapes_delta: dict, trace, device_name: str) -> "float | None":
    """The kernels' share of the bandwidth roofline, in %: the least time
    their launches' bytes need at the card's peak over the time the trace
    shows them running. None when the card has no peak here or nothing of
    theirs ran."""
    peak = PEAK_BYTES_PER_S.get(device_name)
    if peak is None or trace is None:
        return None
    need = sum(launched_bytes(k, shapes_delta.get(k, {})) for k in kernels)
    ran = sum(trace.kernel_seconds(SYMBOL[k]) for k in kernels)
    if need <= 0 or ran <= 0:
        return None
    return 100.0 * (need / peak) / ran


def shapes_now() -> dict:
    """A copy of the port's launch-shape counters."""
    from lasp_tpu_torch.ops import cuda_gossip

    return {k: dict(c) for k, c in cuda_gossip.SHAPES.items()}


def shapes_since(before: dict) -> dict:
    """Launches by shape since ``before`` (a :func:`shapes_now`)."""
    now = shapes_now()
    out = {}
    for k, counts in now.items():
        old = before.get(k, {})
        d = {s: n - old.get(s, 0) for s, n in counts.items() if n > old.get(s, 0)}
        if d:
            out[k] = d
    return out
