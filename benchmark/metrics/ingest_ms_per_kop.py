"""Layer: the write path (``lasp_tpu_torch.mesh.ingest`` and
``ReplicatedRuntime.ingest_cycle``).

Milliseconds of the write path per 1,000 ops as ``ingest_cycle`` takes
them (a field update is a remove and an add): the harness's own span
around each ``ingest_cycle`` of the window, closed by a synchronize of the
device (traced runs only, so the profiler's host cost is in it). Moves
the cell's end-to-end time."""


def read(ctx):
    rec = ctx.driver.records
    ops = sum(rec.ingest_ops)
    if ops <= 0:
        return None
    return 1e6 * sum(rec.ingest_s) / ops
