"""Plan-grouped ingest: client-op batches resolved into op tables on the
host, applied once per dispatch-plan group per cycle (port of
``lasp_tpu.mesh.ingest``).

1. **Encode** (host, once per cycle per variable): a batch of client ops
   becomes an :class:`IngestTable` of named columns — replica rows,
   element / lane / word indices and payloads — with every data-dependent
   decision (OR-Set token-slot allocation, OR-SWOT clock minting, remove
   preconditions) settled by the same host walks the runtime's per-variable
   arm uses, so sequential per-op semantics, persist-prefix-then-raise
   included, hold bit for bit.
2. **Group**: tables group by ``plan.signature_of`` (:func:`group_key`),
   the rule gossip dispatch groups under.
3. **Apply**: one group apply per plan group per cycle
   (:func:`apply_group`) lands every member's table and returns each
   member's exact changed rows (``bool[R]``), which become the frontier's
   dirty marks.

The JAX apply stacks a group's members into ``[G, R, ...]`` under a donated
``jit``, pads every table to a shared power-of-two bucket with the
out-of-range row ``n_replicas`` and scatters with ``mode="drop"``. Eager
PyTorch cannot donate (a stack copies every member population each cycle)
and has no drop mode (on CUDA an out-of-range index is a device-side
assert). So the port scatters each member's own unpadded table into the
member where it lies, inside one group apply: pad slots never reach the
card, and each column of the group crosses to the device in one copy.
:func:`stack_tables` keeps the JAX bucket accounting for the cycle report.

On CUDA ``index_put_`` picks an arbitrary winner when a target repeats with
different values, so every value-carrying write must name each target once:
the encoders leave one entry per target (``_encode_ivar`` keeps the first
set of a row, ``_encode_orswot`` one entry per (row, elem) pair and per
clock lane), the OR-Set tombstones of one (row, elem) are OR-ed on the host
before the scatter (JAX's bool ``max``), and :func:`apply_group` checks all
of it on the host before any scatter. The G-Set and OR-Set mints write
constants; the packed OR-Set's and the G-Counter's adds accumulate.

Each group apply adds one to :data:`GROUP_APPLIES` (the port has no
telemetry registry; this is its count of the JAX
``ingest_apply_dispatches_total``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .plan import signature_of

#: op-kind codes of the logical table encoding
OP_ADD, OP_REMOVE, OP_INCREMENT, OP_SET = 0, 1, 2, 3

#: smallest table bucket; buckets grow by powers of two
_MIN_BUCKET = 8

#: group applies since the module was imported (read as a difference)
GROUP_APPLIES = 0

def bucket_of(n: int) -> int:
    """Smallest power-of-two bucket holding ``n`` slots (min 8); zero stays
    zero."""
    if n <= 0:
        return 0
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class IngestTable:
    """One variable's resolved cycle ops: per-family named columns
    (unpadded host arrays). ``kind`` names the apply family, ``n_ops`` the
    client ops encoded, ``slots`` the scatter slots the table carries."""

    kind: str
    var_id: str
    n_ops: int
    arrays: dict

    @property
    def slots(self) -> int:
        return sum(
            int(a.shape[0]) for n, a in self.arrays.items()
            if n.endswith("rows")
        )


#: row-index columns (JAX pads them with n_replicas, the drop slot)
_ROW_COLS = frozenset(("rows", "m_rows", "t_rows", "d_rows", "c_rows"))


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((0,), dtype=dtype).numpy().dtype


# ---------------------------------------------------------------------------
# encode: ops -> resolved tables (host, sequential semantics preserved)
# ---------------------------------------------------------------------------


def encode_batch(rt, var, tn: str, states, ops):
    """Resolve one variable's op batch into an :class:`IngestTable`.

    Returns ``(table, deferred_err)``; ``(None, None)`` means the type has
    no op-table encode and the caller takes the per-variable arm.
    ``deferred_err`` is the error the batch owes after its valid prefix
    applies (``err.batch_index`` set); the table then covers exactly that
    prefix. Malformed ops raise at once with nothing applied."""
    if tn == "riak_dt_gcounter":
        return _encode_gcounter(var, states, ops), None
    if tn == "lasp_gset":
        return _encode_gset(var, ops), None
    if tn == "lasp_ivar":
        return _encode_ivar(var, states, ops), None
    if tn == "riak_dt_orswot":
        return _encode_orswot(rt, var, states, ops)
    if tn in ("lasp_orset", "lasp_orset_gbtree"):
        if var.id in rt._packed_specs:
            return _encode_orset_packed(rt, var, states, ops)
        return _encode_orset(rt, var, states, ops)
    return None, None


def _encode_gcounter(var, states, ops) -> IngestTable:
    rows, lanes, by = [], [], []
    for r, op, actor in ops:
        if op[0] != "increment":
            raise ValueError(f"update_batch: unsupported op {op!r}")
        amount = op[1] if len(op) > 1 else 1
        if amount < 1:
            # the reference rejects non-positive increments
            raise ValueError(
                f"update_batch: G-Counter increment must be >= 1, "
                f"got {amount!r}"
            )
        rows.append(r)
        lanes.append(var.actors.intern(actor))
        by.append(amount)
    return IngestTable("gcounter", var.id, len(ops), {
        "rows": np.asarray(rows, dtype=np.int32),
        "lanes": np.asarray(lanes, dtype=np.int32),
        "amounts": np.asarray(by, dtype=_np_dtype(states.counts.dtype)),
    })


def _encode_gset(var, ops) -> IngestTable:
    rows, elems = [], []
    for r, op, _actor in ops:
        if op[0] == "add":
            rows.append(r)
            elems.append(var.elems.intern(op[1]))
        elif op[0] == "add_all":
            for e in op[1]:
                rows.append(r)
                elems.append(var.elems.intern(e))
        else:
            raise ValueError(f"update_batch: unsupported op {op!r}")
    return IngestTable("gset", var.id, len(ops), {
        "rows": np.asarray(rows, dtype=np.int32),
        "elems": np.asarray(elems, dtype=np.int32),
    })


def _encode_ivar(var, states, ops) -> IngestTable:
    rows, payloads = [], []
    for r, op, _actor in ops:
        if op[0] != "set":
            raise ValueError(f"update_batch: unsupported op {op!r}")
        rows.append(r)
        payloads.append(var.ivar_payloads.intern(op[1]))
    n_ops = len(ops)
    rows = np.asarray(rows, dtype=np.int32)
    payloads = np.asarray(payloads, dtype=_np_dtype(states.value.dtype))
    # sequential semantics: per row the first set wins, and an already
    # defined row keeps its value (single assignment)
    if rows.size:
        _, first = np.unique(rows, return_index=True)
        rows, payloads = rows[first], payloads[first]
        open_rows = ~take_rows(states.defined, rows)
        rows, payloads = rows[open_rows], payloads[open_rows]
    return IngestTable("ivar", var.id, n_ops, {"rows": rows, "vals": payloads})


def _encode_orswot(rt, var, states, ops):
    fail_op, err = rt._orswot_precheck(var, ops)
    if err is not None:
        err.batch_index = fail_op
        ops = ops[:fail_op]
    n_ops = len(ops)
    # flat (kind, replica, elem, actor) items: every op of the prefix is
    # known to succeed
    flat: list = []
    for r, op, actor in ops:
        verb = op[0]
        if verb in ("add", "add_all"):
            a = var.actors.intern(actor)
            terms = op[1] if verb == "add_all" else [op[1]]
            flat.extend(("add", r, var.elems.intern(e), a) for e in terms)
        else:
            terms = op[1] if verb == "remove_all" else [op[1]]
            flat.extend(("remove", r, var.elems.index_of(e), -1) for e in terms)
    pairs = sorted({(int(r), int(e)) for _k, r, e, _a in flat})
    actors = sorted({(int(r), int(a)) for _k, r, _e, a in flat if a >= 0})
    pr = np.asarray([p[0] for p in pairs], dtype=np.int32)
    pe = np.asarray([p[1] for p in pairs], dtype=np.int32)
    dot_rows = {
        p: np.array(d) for p, d in zip(pairs, take_pairs(states.dots, pr, pe))
    } if pairs else {}
    if actors:
        cr = np.asarray([a[0] for a in actors], dtype=np.int32)
        ca = np.asarray([a[1] for a in actors], dtype=np.int32)
        clocks = {
            a: int(c) for a, c in zip(actors, take_pairs(states.clock, cr, ca))
        }
    else:
        clocks = {}
    for kind, r, e, a in flat:
        if kind == "add":
            key = (int(r), int(a))
            clocks[key] += 1
            row = np.zeros_like(dot_rows[(int(r), int(e))])
            row[int(a)] = clocks[key]
            dot_rows[(int(r), int(e))] = row
        else:
            dot_rows[(int(r), int(e))][:] = 0
    dots_dt = _np_dtype(states.dots.dtype)
    clock_dt = _np_dtype(states.clock.dtype)
    d_vals = (
        np.stack([dot_rows[p] for p in pairs]).astype(dots_dt)
        if pairs else np.zeros((0, int(states.dots.shape[-1])), dots_dt)
    )
    table = IngestTable("orswot", var.id, n_ops, {
        "d_rows": pr,
        "d_elems": pe,
        "d_vals": d_vals,
        "c_rows": np.asarray([k[0] for k in clocks], dtype=np.int32),
        "c_lanes": np.asarray([k[1] for k in clocks], dtype=np.int32),
        "c_vals": np.asarray(list(clocks.values()), dtype=clock_dt),
    })
    return table, err


def _take_fill(dtype: torch.dtype, words: bool):
    """The value ``jnp.take`` (mode "fill") returns at an out-of-range
    index: True for bool, the most negative value for a signed leaf, all
    ones for the packed words (uint32 planes in JAX, int32 here)."""
    if dtype == torch.bool:
        return True
    if words:
        return -1
    return torch.iinfo(dtype).min


def take_rows(plane: torch.Tensor, idx, words: bool = False) -> np.ndarray:
    """``plane[idx]`` along the leading axis as one gather, pulled to the
    host (O(batch), never the population), with ``jnp.take``'s index
    rule: a negative index wraps once, an index still outside the plane
    reads the fill value (:func:`_take_fill`). Only valid indices reach
    the device. ``words``: the plane holds packed uint32 words."""
    idx, ok = wrap_index(np.asarray(idx, dtype=np.int64), int(plane.shape[0]))
    out = np.empty((idx.shape[0],) + tuple(plane.shape[1:]),
                   dtype=_np_dtype(plane.dtype))
    out[~ok] = _take_fill(plane.dtype, words)
    if ok.any():
        index = torch.as_tensor(idx[ok], device=plane.device)
        out[ok] = plane[index].cpu().numpy()
    return out


def take_pairs(plane: torch.Tensor, rs, es) -> np.ndarray:
    """``plane[rs, es]`` of an ``[R, E, ...]`` plane as one flat gather
    (JAX flattens the pair the same way before its ``take``)."""
    e = int(plane.shape[1])
    flat = np.asarray(rs, dtype=np.int64) * e + np.asarray(es, dtype=np.int64)
    return take_rows(plane.reshape((-1,) + tuple(plane.shape[2:])), flat)


def wrap_index(idx: np.ndarray, size: int) -> tuple:
    """``(index, valid)``: negative indices wrapped once, as JAX normalises
    them, and the mask of those in ``[0, size)``."""
    idx = np.where(idx < 0, idx + size, idx)
    return idx, (idx >= 0) & (idx < size)


class _PairCache:
    """Host cache of the OR-Set token rows a batch touches: one pull of
    every touched pair, then an overlay that carries the batch's own
    evolution."""

    def __init__(self, exists, removed, pairs):
        self.ex: dict = {}
        self.rm: dict = {}
        need = sorted(set(pairs))
        if not need:
            return
        rs = np.asarray([p[0] for p in need], dtype=np.int32)
        es = np.asarray([p[1] for p in need], dtype=np.int32)
        got_ex = take_pairs(exists, rs, es)
        got_rm = take_pairs(removed, rs, es)
        for i, p in enumerate(need):
            self.ex[p] = np.array(got_ex[i])
            self.rm[p] = np.array(got_rm[i])


def _encode_orset(rt, var, states, ops):
    """Dense OR-Set encode: the per-variable arm's phase walk (maximal
    same-verb runs, shared ``_alloc_pool_slots`` / ``_check_removes`` /
    ``_atomic_prefix``) over a host overlay of the touched token rows,
    emitting mint triples and tombstone rows."""
    k = var.spec.tokens_per_actor
    phases = _orset_phases(var, ops, k)
    # every pair the batch touches, pulled once: first-touch values are
    # the state before the batch, the overlay carries the rest
    cache = _PairCache(states.exists, states.removed, [
        (int(it[0]), int(it[1]))
        for kind, items in phases
        for it in items
        if kind == "add" or it[1] >= 0
    ])
    m_rows: list = []
    m_elems: list = []
    m_slots: list = []
    t_rows: list = []
    t_elems: list = []
    t_vals: list = []
    err = None
    for kind, items in phases:
        if kind == "add":
            pairs = [(int(it[0]), int(it[1])) for it in items]
            pools = np.stack([
                cache.ex[p][it[2]: it[2] + k] for p, it in zip(pairs, items)
            ]) if items else np.zeros((0, k), bool)
            allocs, err = rt._alloc_pool_slots(var.id, items, pools, k)
            allocs = allocs[: rt._atomic_prefix(items, len(allocs), err)]
            for i, slot in allocs:
                r, e, base = items[i][0], items[i][1], items[i][2]
                p = (int(r), int(e))
                cache.ex[p][base + slot] = True
                cache.rm[p][base + slot] = False
                m_rows.append(r)
                m_elems.append(e)
                m_slots.append(base + slot)
            if err is not None:
                break
        else:
            live = np.asarray([
                bool((cache.ex[(int(r), int(e))]
                      & ~cache.rm[(int(r), int(e))]).any())
                if e >= 0 else False
                for r, e, _term, _opk in items
            ])
            n_ok, err = rt._check_removes(items, live)
            ok_count = rt._atomic_prefix(items, n_ok, err)
            for r, e, _term, _opk in items[:ok_count]:
                p = (int(r), int(e))
                t_rows.append(r)
                t_elems.append(e)
                # removed |= exists: the tombstone row is the current
                # exists row, the batch's own mints included
                t_vals.append(cache.ex[p].copy())
                cache.rm[p] |= cache.ex[p]
            if err is not None:
                break
    t = int(states.exists.shape[-1])
    table = IngestTable("orset", var.id, len(ops), {
        "m_rows": np.asarray(m_rows, dtype=np.int32),
        "m_elems": np.asarray(m_elems, dtype=np.int32),
        "m_slots": np.asarray(m_slots, dtype=np.int32),
        "t_rows": np.asarray(t_rows, dtype=np.int32),
        "t_elems": np.asarray(t_elems, dtype=np.int32),
        "t_vals": np.stack(t_vals) if t_vals else np.zeros((0, t), bool),
    })
    return table, err


def _orset_phases(var, ops, k):
    """The per-variable arm's phase split: maximal same-verb runs in op
    order, each item carrying its op index last (the per-op atomicity
    boundary ``_atomic_prefix`` trims at)."""
    phases: list = []
    for opk, (r, op, actor) in enumerate(ops):
        verb = op[0]
        if verb in ("add", "add_all"):
            kind = "add"
            a = var.actors.intern(actor)
            terms = op[1] if verb == "add_all" else [op[1]]
            items = [(r, var.elems.intern(e), a * k, e, opk) for e in terms]
        elif verb in ("remove", "remove_all"):
            kind = "remove"
            terms = op[1] if verb == "remove_all" else [op[1]]
            items = [
                (r, var.elems.index_of(e) if e in var.elems else -1, e, opk)
                for e in terms
            ]
        else:
            raise ValueError(f"update_batch: unsupported op {op!r}")
        if phases and phases[-1][0] == kind:
            phases[-1][1].extend(items)
        else:
            phases.append((kind, items))
    return phases


def _encode_orset_packed(rt, var, states, ops):
    """Packed-mode twin: the same phase walk over per-row word overlays,
    emitting per-(row, word) delta masks of new bits only (mints target
    free slots, tombstones exclude set bits), so an add-scatter of them
    never carries and equals a bitwise or."""
    pspec = rt._packed_specs[var.id]
    d = pspec.dense
    k = d.tokens_per_actor
    elem_masks = rt._elem_word_masks(var.id)
    phases = _orset_phases(var, ops, k)

    ex_rows: dict = {}
    rm_rows: dict = {}

    def fetch(rows):
        need = sorted({int(r) for r in rows if int(r) not in ex_rows})
        if not need:
            return
        rs = np.asarray(need, dtype=np.int32)
        got_ex = take_rows(states.exists, rs, words=True).view(np.uint32)
        got_rm = take_rows(states.removed, rs, words=True).view(np.uint32)
        for i, r in enumerate(need):
            ex_rows[r] = np.array(got_ex[i])
            rm_rows[r] = np.array(got_rm[i])

    # one pull of every touched row's words (the state before the batch)
    fetch([it[0] for _kind, items in phases for it in items])
    mint: dict = {}  # (row, word) -> uint32 delta mask
    tomb: dict = {}
    err = None
    for kind, items in phases:
        if kind == "add":
            elems = np.asarray([it[1] for it in items], dtype=np.int64)
            bases = np.asarray([it[2] for it in items], dtype=np.int64)
            bits = elems[:, None] * d.n_tokens + bases[:, None] + np.arange(k)
            words, shifts = bits // 32, bits % 32
            pools = np.stack([
                ((ex_rows[int(it[0])][words[i]]
                  >> shifts[i].astype(np.uint32)) & 1).astype(bool)
                for i, it in enumerate(items)
            ]) if items else np.zeros((0, k), bool)
            allocs, err = rt._alloc_pool_slots(var.id, items, pools, k)
            allocs = allocs[: rt._atomic_prefix(items, len(allocs), err)]
            for i, slot in allocs:
                b = int(bits[i, slot])
                r = int(items[i][0])
                w, m = b // 32, np.uint32(1) << np.uint32(b % 32)
                ex_rows[r][w] |= m
                mint[(r, w)] = np.uint32(mint.get((r, w), 0) | m)
            if err is not None:
                break
        else:
            live = np.asarray([
                bool((((ex_rows[int(r)] & ~rm_rows[int(r)])
                       & elem_masks[int(e)]) != 0).any())
                if e >= 0 else False
                for r, e, _term, _opk in items
            ])
            n_ok, err = rt._check_removes(items, live)
            ok_count = rt._atomic_prefix(items, n_ok, err)
            for r, e, _term, _opk in items[:ok_count]:
                r = int(r)
                new = (ex_rows[r] & ~rm_rows[r]) & elem_masks[int(e)]
                for w in np.flatnonzero(new):
                    tomb[(r, int(w))] = np.uint32(tomb.get((r, int(w)), 0) | new[w])
                rm_rows[r] |= ex_rows[r] & elem_masks[int(e)]
            if err is not None:
                break

    def unzip(dct):
        rows = np.asarray([p[0] for p in dct], dtype=np.int32)
        words = np.asarray([p[1] for p in dct], dtype=np.int32)
        masks = np.asarray(list(dct.values()), dtype=np.uint32)
        return rows, words, masks

    m_r, m_w, m_m = unzip(mint)
    t_r, t_w, t_m = unzip(tomb)
    table = IngestTable("orset_packed", var.id, len(ops), {
        "m_rows": m_r, "m_words": m_w, "m_masks": m_m,
        "t_rows": t_r, "t_words": t_w, "t_masks": t_m,
    })
    return table, err


# ---------------------------------------------------------------------------
# apply: each member's table scattered into the member in place
# ---------------------------------------------------------------------------


def _apply_gset(state, tab):
    rows, elems = tab["rows"], tab["elems"]
    old = state.mask[rows, elems]  # read before the write: the change flags
    state.mask[rows, elems] = True
    return ~old


def _apply_gcounter(state, tab):
    state.counts.index_put_(
        (tab["rows"], tab["lanes"]), tab["amounts"], accumulate=True
    )


def _apply_ivar(state, tab):
    rows = tab["rows"]
    state.defined[rows] = True
    state.value[rows] = tab["vals"]


def _apply_orset(state, tab):
    mint = (tab["m_rows"], tab["m_elems"], tab["m_slots"])
    state.exists[mint] = True
    state.removed[mint] = False
    # tombstones OR in after the mints (removed |= exists at remove time,
    # resolved on the host): a tombstone row holds a minted slot only when
    # the remove followed the mint
    tomb = (tab["t_rows"], tab["t_elems"])
    state.removed[tomb] = state.removed[tomb] | tab["t_vals"]


def _apply_orset_packed(state, tab):
    # the delta masks carry new bits only, so the int32 add never carries
    # (bit 31 wraps in two's complement) and equals a bitwise or
    state.exists.index_put_(
        (tab["m_rows"], tab["m_words"]), tab["m_masks"], accumulate=True
    )
    state.removed.index_put_(
        (tab["t_rows"], tab["t_words"]), tab["t_masks"], accumulate=True
    )


def _apply_orswot(state, tab):
    state.dots[tab["d_rows"], tab["d_elems"]] = tab["d_vals"]
    state.clock[tab["c_rows"], tab["c_lanes"]] = tab["c_vals"]


_APPLIERS = {
    "gset": _apply_gset,
    "gcounter": _apply_gcounter,
    "ivar": _apply_ivar,
    "orset": _apply_orset,
    "orset_packed": _apply_orset_packed,
    "orswot": _apply_orswot,
}

#: the row columns each family marks changed (every slot of them changes,
#: given its precondition; the G-Set's ``rows`` only where the element was
#: absent, from its applier's flags)
_MARK_COLS = {
    "gset": ("rows",),
    "gcounter": ("rows",),
    "ivar": ("rows",),
    "orset": ("m_rows", "t_rows"),
    "orset_packed": ("m_rows", "t_rows"),
    "orswot": ("d_rows", "c_rows"),
}

#: per family, the targets of its value-carrying writes, which must not
#: repeat within one table (``index_put_`` would pick an arbitrary winner)
_UNIQUE_TARGETS = {
    "ivar": (("rows", None),),
    "orset": (("t_rows", "t_elems"),),
    "orset_packed": (("m_rows", "m_words"), ("t_rows", "t_words")),
    "orswot": (("d_rows", "d_elems"), ("c_rows", "c_lanes")),
}


def _or_tombstones(arrays: dict) -> dict:
    """A dense OR-Set table with each (row, elem) tombstone target once,
    its rows OR-ed (JAX's bool ``max`` scatter); other columns unchanged."""
    rows, elems = arrays["t_rows"], arrays["t_elems"]
    if rows.size < 2:
        return arrays
    keys = rows.astype(np.int64) << 32 | elems.astype(np.int64)
    uniq, inv = np.unique(keys, return_inverse=True)
    if uniq.size == keys.size:
        return arrays
    vals = np.zeros((uniq.size,) + arrays["t_vals"].shape[1:], dtype=bool)
    np.logical_or.at(vals, inv, arrays["t_vals"])
    out = dict(arrays)
    out["t_rows"] = (uniq >> 32).astype(np.int32)
    out["t_elems"] = (uniq & 0xFFFFFFFF).astype(np.int32)
    out["t_vals"] = vals
    return out


def _drop_outside(arrays: dict, n_replicas: int) -> dict:
    """A table with each row column wrapped once and its out-of-range
    entries dropped, together with the columns of the same write (those
    sharing the row column's prefix: ``m_rows`` carries ``m_elems`` and
    ``m_slots``; a bare ``rows`` carries every column)."""
    out = dict(arrays)
    for name in arrays:
        if name not in _ROW_COLS:
            continue
        rows, ok = wrap_index(arrays[name].astype(np.int64), n_replicas)
        prefix = name[: -len("rows")]
        for col in arrays:
            if col.startswith(prefix):
                out[col] = arrays[col][ok]
        out[name] = rows[ok].astype(arrays[name].dtype)
    return out


def _check_targets(kind: str, arrays: dict) -> None:
    """No value-carrying target repeated within one table: on the card a
    repeated target would take an arbitrary one of its values."""
    for rows, cols in _UNIQUE_TARGETS.get(kind, ()):
        keys = arrays[rows].astype(np.int64)
        if cols is not None and keys.size:
            c = arrays[cols].astype(np.int64)
            keys = keys * (int(c.max()) + 1) + c
        if np.unique(keys).size != keys.size:
            raise RuntimeError(
                f"ingest {kind}: a value-carrying write repeats its target "
                f"({rows}, {cols})"
            )


#: value columns written into a state leaf, by (family, column): the leaf
_VALUE_LEAF = {
    ("gcounter", "amounts"): "counts",
    ("ivar", "vals"): "value",
    ("orswot", "d_vals"): "dots",
    ("orswot", "c_vals"): "clock",
}


def _device_column(kind: str, name: str, values: np.ndarray, state) -> torch.Tensor:
    """One host column of a group on the state's device: a value column in
    its leaf's dtype, packed words as the int32 planes' bit pattern, bool
    rows as bool, indices as int64."""
    leaf = _VALUE_LEAF.get((kind, name))
    if leaf is not None:
        dtype = getattr(state, leaf).dtype
    elif values.dtype == np.uint32:
        values, dtype = values.view(np.int32), torch.int32
    elif values.dtype == np.bool_:
        dtype = torch.bool
    else:
        dtype = torch.int64
    return torch.from_numpy(np.ascontiguousarray(values)).to(
        device=state[0].device, dtype=dtype
    )


def apply_group(kind: str, states: list, tables: list, n_replicas: int) -> list:
    """One group apply: land each member's table in its state, in place,
    and return each member's changed rows as a host ``bool[R]`` (the exact
    dirty marks). ``states`` and ``tables`` are in member order and share
    one signature, so one device copy per column serves the whole group;
    the only host sync is the G-Set's read of its change flags. Row
    indices follow JAX's ``mode="drop"`` scatter: a negative row wraps
    once, a row still outside ``[0, n_replicas)`` drops with its entry,
    on the host (:func:`_drop_outside`), so the card never sees one."""
    global GROUP_APPLIES
    applier = _APPLIERS[kind]
    arrays = [_drop_outside(t.arrays, n_replicas) for t in tables]
    if kind == "orset":
        arrays = [_or_tombstones(a) for a in arrays]
    for a in arrays:
        _check_targets(kind, a)
    cols = {}
    for name in arrays[0]:
        lengths = [int(a[name].shape[0]) for a in arrays]
        cat = np.concatenate([a[name] for a in arrays])
        cols[name] = torch.split(_device_column(kind, name, cat, states[0]), lengths)
    GROUP_APPLIES += 1
    flags = []
    for i, state in enumerate(states):
        tab = {name: parts[i] for name, parts in cols.items()}
        if any(int(p.shape[0]) for p in tab.values()):
            flags.append(applier(state, tab))
        else:
            flags.append(None)
    if kind == "gset":
        # the members' flags cross to the host together
        live = [f for f in flags if f is not None]
        host = torch.cat(live).cpu().numpy() if live else np.zeros(0, bool)
        parts = iter(np.split(host, np.cumsum([int(f.shape[0]) for f in live])[:-1]))
        flags = [next(parts) if f is not None else None for f in flags]
    changed = []
    for a, f in zip(arrays, flags):
        mask = np.zeros(n_replicas, dtype=bool)
        for name in _MARK_COLS[kind]:
            rows = a[name]
            if kind == "gset":
                rows = rows[f] if f is not None else rows[:0]
            mask[rows] = True
        changed.append(mask)
    return changed


# ---------------------------------------------------------------------------
# grouping
# ---------------------------------------------------------------------------


def group_key(rt, var_id: str):
    """The grouping signature of one variable's table, the rule gossip
    dispatch groups under (``plan.signature_of``); an unhashable spec rides
    a singleton group keyed by identity."""
    sig = signature_of(rt, var_id)
    return sig if sig is not None else ("singleton", var_id)


def table_buckets(tables) -> tuple:
    """``(buckets, pad_slots)`` of a group's tables padded to shared
    power-of-two buckets: ``((name, bucket), ...)`` per column, and the pad
    slots of the row columns (JAX's pad-waste count)."""
    buckets = []
    pad_slots = 0
    for name in tables[0].arrays:
        width = max(int(t.arrays[name].shape[0]) for t in tables)
        b = bucket_of(width)
        buckets.append((name, b))
        if name in _ROW_COLS:
            pad_slots += sum(b - int(t.arrays[name].shape[0]) for t in tables)
    return tuple(buckets), pad_slots


def stack_tables(tables, n_replicas: int):
    """Pad each member's columns to shared power-of-two buckets and stack to
    ``[G, B, ...]``, row columns padded with ``n_replicas`` and value
    columns with zeros (the JAX layout; the port's apply never sends the
    pads to the card). Returns ``(stacked, buckets, pad_slots)``."""
    buckets, pad_slots = table_buckets(tables)
    stacked = {}
    for name, b in buckets:
        cols = []
        for t in tables:
            a = t.arrays[name]
            pad = b - int(a.shape[0])
            if pad:
                fill = np.zeros((pad,) + a.shape[1:], dtype=a.dtype)
                if name in _ROW_COLS:
                    fill[:] = n_replicas
                a = np.concatenate([a, fill])
            cols.append(a)
        stacked[name] = np.stack(cols) if cols else None
    return stacked, buckets, pad_slots
