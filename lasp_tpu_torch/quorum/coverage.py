"""Ring-coverage queries: partition-sweep map-merge, one grouped plan per
dispatch-plan group (port of ``lasp_tpu.quorum.coverage``).

The reference's coverage execute (``src/lasp_execute_coverage_fsm.erl:
50-97``) opens a coverage plan over the ring, folds each partition's
accumulator locally (the MAP), and merges every partition's CRDT with
``Type:merge`` at the coordinator (the MERGE) before ``Type:value`` +
``Module:value``. The port keeps that two-phase structure — per-shard
partial joins over contiguous ``shard_rows`` blocks, then a log-depth merge
of the shard partials — because associativity and commutativity of the
join make it bit-identical to any other join schedule.

Batching: variables sharing a mesh signature (``mesh.plan.signature_of``)
share ONE sweep. Shard by shard, the members' rows of the block (contiguous
slices, no gather) stack into a ``[G, R/S, ...]`` tensor and every join
runs over the group axis, so the device kernels a sweep launches do not
grow with G while a block's ``G·(R/S)`` rows fit the 32-bit offsets of
PyTorch's elementwise kernels (past that, each operation splits). The
stack copies every member once, one block at a time, so the copy never
holds more than a block. A store full of 2i index views
(``programs/riak_index.py`` auto-registers one OR-Set per observed index
spec, all of one spec) answers every view's coverage execute in one sweep.
"""

from __future__ import annotations

import torch

from ..chaos.schedule import shard_rows
from ..lattice.base import tree_map
from ..mesh.plan import signature_of, stack_group
from ..mesh.programs import MeshSession
from ..telemetry import counter, span

#: sweep plan cache, keyed by (codec, spec-hashable, G, R, S)
_sweep_cache: dict = {}


def _or_words(x, y):
    """``x | y``, bool flags ORed eight to a 64-bit lane where the trailing
    axis allows (the same bytes: a bool is 0 or 1)."""
    if (x.dtype == torch.bool and x.shape[-1] % 8 == 0 and x.stride(-1) == 1
            and y.stride(-1) == 1 and x.storage_offset() % 8 == 0
            and y.storage_offset() % 8 == 0
            and all(st % 8 == 0 for st in x.stride()[:-1] + y.stride()[:-1])):
        return (x.view(torch.int64) | y.view(torch.int64)).view(torch.bool)
    return x | y


def _merge(codec, spec, a, b):
    """The codec's join of two ``[G, n, ...]`` operands; a leafwise-OR
    codec's leaves OR as words (bit-identical to ``codec.merge``)."""
    if getattr(codec, "leafwise_join", None) == "or":
        return tree_map(_or_words, a, b)
    return codec.merge(spec, a, b)


def _join_axis1(codec, spec, states):
    """Full join over axis 1 of ``[G, n, ...]`` leaves -> ``[G, ...]``:
    ``mesh.gossip.join_all``'s log-depth halving, one merge a level over
    the whole group (odd lengths pad by repeating the last row)."""
    n = states[0].shape[1]
    while n > 1:
        if n % 2:
            states = tree_map(lambda x: torch.cat([x, x[:, -1:]], dim=1), states)
            n += 1
        half = n // 2
        states = _merge(
            codec, spec,
            tree_map(lambda x: x[:, :half], states),
            tree_map(lambda x: x[:, half:], states),
        )
        n = half
    return tree_map(lambda x: x[:, 0], states)


def _sweep_fn(codec, spec, g: int, n_replicas: int, n_shards: int):
    """The grouped partition sweep: G member populations (``[R, ...]``
    each) -> ``[G, ...]`` coverage tops. Per contiguous ``shard_rows``
    block, the members' block rows stack into ``[G, R/S, ...]`` and join to
    a partial (the map phase); then one log-depth merge of the S partials.
    Cached like JAX's jitted sweep (the block bounds are host constants of
    the key)."""
    key = (codec, repr(spec), g, n_replicas, n_shards)
    fn = _sweep_cache.get(key)
    if fn is not None:
        return fn
    bounds = []
    for s in range(n_shards):
        rows = shard_rows(n_replicas, n_shards, s)
        bounds.append((int(rows[0]), int(rows[-1]) + 1))

    def fn(members):
        partials = [
            _join_axis1(codec, spec, stack_group(
                [tree_map(lambda x, a=lo, b=hi: x[a:b], m) for m in members]))
            for lo, hi in bounds
        ]
        stacked = tree_map(lambda *xs: torch.stack(xs, dim=1), *partials)
        return _join_axis1(codec, spec, stacked)

    _sweep_cache[key] = fn
    return fn


def coverage_sweep(rt, var_ids=None, n_shards: int = 4) -> dict:
    """Coverage values for ``var_ids`` (default: every variable):
    ``{var_id: decoded value}``, computed as grouped partition-sweep
    map-merges — one sweep per plan group, not per variable. Each result
    is bit-identical to ``rt.coverage_value(var_id)``, which serves a
    runtime sharded across processes: there each process holds only its
    rows, and ``coverage_value`` folds every process's partial."""
    ids = list(rt.var_ids if var_ids is None else var_ids)
    if rt._dist is not None:
        return {v: rt.coverage_value(v) for v in ids}
    for v in ids:
        rt._population(v)  # sync late declares before grouping
    n_shards = max(1, min(int(n_shards), rt.n_replicas))
    groups: dict = {}
    for v in ids:
        sig = signature_of(rt, v)
        groups.setdefault(sig if sig is not None else ("singleton", v), []).append(v)
    out: dict = {}
    with span("quorum.coverage", vars=len(ids), groups=len(groups)):
        for members in groups.values():
            codec, spec = rt._mesh_meta(members[0])
            fn = _sweep_fn(codec, spec, len(members), rt.n_replicas, n_shards)
            tops = fn([rt._population(v) for v in members])
            for i, v in enumerate(members):
                top = tree_map(lambda x, _i=i: x[_i], tops)
                var = rt.store.variable(v)
                out[v] = rt.store._decode_value(var, rt._to_dense_row(v, top))
    counter(
        "quorum_coverage_queries_total",
        help="grouped ring-coverage sweeps executed (one count per "
             "sweep call, any number of variables)",
    ).inc()
    return out


class _CoverageSession(MeshSession):
    """A MeshSession whose coverage reads serve from a precomputed grouped
    sweep — programs' ``execute`` callbacks read their accumulator without
    one join per program."""

    def __init__(self, runtime, values: dict):
        super().__init__(runtime)
        self._values = values

    def value(self, var_id: str):
        if self.replica is None and self.quorum is None:
            if var_id in self._values:
                return self._values[var_id]
        return super().value(var_id)


def ring_coverage_execute(rt, names=None, n_shards: int = 4) -> dict:
    """Coverage-execute every named program (default: all registered)
    against ONE grouped partition sweep: ``{name: program value}`` — the
    reference's ``execute(global)`` fan-out, every 2i index view merged
    over the ring, one sweep per plan group. Results are bit-identical to
    per-program ``rt.execute(name)``."""
    programs = rt.programs
    names = list(programs if names is None else names)
    missing = [n for n in names if n not in programs]
    if missing:
        raise KeyError(f"unknown program(s) {missing!r}")
    acc_ids = [
        programs[n].id for n in names
        if getattr(programs[n], "id", None) is not None
    ]
    values = coverage_sweep(rt, acc_ids, n_shards=n_shards) if acc_ids else {}
    session = _CoverageSession(rt, values)
    out = {}
    for n in names:
        program = programs[n]
        out[n] = program.value(program.execute(session))
    return out
