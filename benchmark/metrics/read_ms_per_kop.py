"""Layer: the read path (``ReplicatedRuntime.replica_value``).

Milliseconds of a burst's reads per 1,000 reads: the harness's own span
around each burst's reads, each a ``replica_value`` of a whole record at
its replica (traced runs only, so the profiler's host cost is in it).
Moves the cell's end-to-end time."""


def read(ctx):
    rec = ctx.driver.records
    ops = sum(getattr(rec, "read_ops", ()))
    if ops <= 0:
        return None
    return 1e6 * sum(rec.read_s) / ops
