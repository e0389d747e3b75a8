"""Vectorized threshold fan-out (port of ``lasp_tpu.serve.subscriptions``):
registered threshold-reads and ``wait_needed`` watches evaluated as ONE
pass over a subscription tensor per variable.

Subscriptions are laid out as dense host arrays per (variable, codec)
group: threshold states stack leafwise into ``[S, ...]`` numpy arrays
(geometric capacity growth, so registration is an O(row) append), with
per-watch replica targets, strictness flags and live flags beside them.
One evaluation gathers each watch's replica row from the population on
its device and computes every verdict in one batched pass per group:

- **numeric** (G-Counter): thresholds against the row total, the codec's
  dtype-pinned sum (``lattice.gcounter``), the thresholds narrowed to the
  counter dtype as JAX's ``jnp.asarray`` narrows them;
- **equality** (IVar): ``{strict, undefined}`` = became-defined,
  non-strict = exact value match;
- **default** (G-Set / OR-Set / OR-SWOT / Map): (strict) inflation past
  the threshold state, the codecs' batched ``is_inflation`` /
  ``is_strict_inflation`` over the gathered rows.

A codec with a ``threshold_met`` override this module does not know falls
back to the per-watch reference path (counted). The per-watch path
(:meth:`SubscriptionTable.evaluate_pervar`) is also the parity reference;
it runs on a host copy of the population (one copy per group, not one
device round trip per watch).

**Fire-exactly-once**: verdicts are claimed under the table lock. Replica
targets clamp to the current population at evaluation time, and a
membership shrink re-homes watches (:meth:`SubscriptionTable.rehome`).
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..lattice.base import Threshold, _structure, tree_leaves, tree_map, tree_unflatten
from ..lattice.gcounter import _sum as _gcounter_total
from ..telemetry import counter, gauge

#: initial per-group capacity; grows geometrically (powers of two, as JAX's
#: groups grow)
_MIN_CAP = 8


def _next_pow2(n: int) -> int:
    b = _MIN_CAP
    while b < n:
        b <<= 1
    return b


#: claim-failure sentinel: a watch registered with payload=None must
#: still fire — None cannot mean "already claimed"
_MISSING = object()


class _Group:
    """All subscriptions of one variable: struct-of-arrays over the
    watch axis. Host arrays are numpy (append = row write); the stacked
    threshold leaves convert to device arrays per evaluation."""

    __slots__ = (
        "var_id", "numeric", "treedef", "leaves", "strict", "replica",
        "active", "payloads", "sub_ids", "n", "cap", "retired",
    )

    def __init__(self, var_id: str, numeric: bool):
        self.var_id = var_id
        self.numeric = numeric
        self.treedef = None
        self.leaves: "list[np.ndarray]" = []
        self.strict = np.zeros(_MIN_CAP, dtype=bool)
        self.replica = np.zeros(_MIN_CAP, dtype=np.int32)
        self.active = np.zeros(_MIN_CAP, dtype=bool)
        self.payloads: list = [None] * _MIN_CAP
        self.sub_ids = np.zeros(_MIN_CAP, dtype=np.int64)
        self.n = 0
        self.cap = _MIN_CAP
        #: fired/cancelled/expired slots not yet compacted away —
        #: sustained threshold-read churn must not grow the group (and
        #: its evaluation bucket) without bound
        self.retired = 0

    def _grow(self, need: int) -> None:
        new_cap = _next_pow2(need)
        if new_cap <= self.cap:
            return

        def wider(arr, fill=0):
            out = np.full((new_cap,) + arr.shape[1:], fill, dtype=arr.dtype)
            out[: self.n] = arr[: self.n]
            return out

        self.strict = wider(self.strict)
        self.replica = wider(self.replica)
        self.active = wider(self.active)
        self.sub_ids = wider(self.sub_ids)
        self.leaves = [wider(leaf) for leaf in self.leaves]
        self.payloads.extend([None] * (new_cap - self.cap))
        self.cap = new_cap

    def append(self, sub_id: int, thr: Threshold, replica: int,
               payload) -> int:
        self._grow(self.n + 1)
        i = self.n
        if self.numeric:
            if not self.leaves:
                self.leaves = [np.zeros(self.cap, dtype=np.int64)]
            self.leaves[0][i] = int(thr.state)
        else:
            flat = [
                x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x)
                for x in tree_leaves(thr.state)
            ]
            structure = _structure(thr.state)
            if self.treedef is None:
                # the first threshold is the template its group rebuilds
                # states from (``threshold_at``, the batched verdict)
                self.treedef = (structure, thr.state)
                self.leaves = [
                    np.zeros((self.cap,) + leaf.shape, dtype=leaf.dtype)
                    for leaf in flat
                ]
            elif structure != self.treedef[0] or any(
                leaf.shape != slot.shape[1:]
                for leaf, slot in zip(flat, self.leaves)
            ):
                raise TypeError(
                    f"threshold structure mismatch on {self.var_id!r}: "
                    "all thresholds of one variable must share the "
                    "spec's state shape"
                )
            for slot, leaf in zip(self.leaves, flat):
                slot[i] = leaf
        self.strict[i] = bool(thr.strict)
        self.replica[i] = int(replica)
        self.active[i] = True
        self.payloads[i] = payload
        self.sub_ids[i] = sub_id
        self.n += 1
        return i

    def threshold_at(self, i: int):
        """Reconstruct watch ``i``'s Threshold (host tensors; the per-watch
        reference path reads it)."""
        if self.numeric:
            state: Any = int(self.leaves[0][i])
        else:
            state = tree_unflatten(
                self.treedef[1],
                [torch.from_numpy(np.array(leaf[i])) for leaf in self.leaves],
            )
        return Threshold(state, bool(self.strict[i]))


class SubscriptionTable:
    """Registered threshold watches over many variables; see the module
    doc. Thread-safe: registration, cancellation, and evaluation may
    interleave from any threads."""

    def __init__(self):
        self._lock = threading.RLock()
        self._groups: dict = {}
        #: sub_id -> (var_id, slot)
        self._index: dict = {}
        self._ids = itertools.count()
        #: (deadline, sub_id) min-heap — only deadline-carrying watches
        self._deadlines: list = []
        #: per-(codec, spec-key) group-verdict functions
        self._kernels: dict = {}
        self.fired_total = 0
        self.pervar_fallbacks = 0

    # -- registration ---------------------------------------------------------
    def register(self, var_id: str, codec, spec, threshold: Threshold,
                 *, replica: int = 0, deadline: Optional[float] = None,
                 payload: Any = None) -> int:
        """Park one resolved threshold watch; returns its sub_id. The
        threshold must already be resolved (``store._resolve_threshold``
        semantics: no None states)."""
        numeric = codec.name == "riak_dt_gcounter"
        with self._lock:
            group = self._groups.get(var_id)
            if group is None:
                group = self._groups[var_id] = _Group(var_id, numeric)
            self._maybe_compact(var_id, group)
            sub_id = next(self._ids)
            slot = group.append(sub_id, threshold, replica, payload)
            self._index[sub_id] = (var_id, slot)
            if deadline is not None:
                heapq.heappush(self._deadlines, (float(deadline), sub_id))
        gauge(
            "serve_watch_subscriptions",
            help="threshold watches currently registered in the "
                 "subscription table",
        ).set(len(self._index))
        return sub_id

    def cancel(self, sub_id: int) -> "Any | None":
        """Deactivate a watch; returns its payload (None when unknown
        or already fired/cancelled)."""
        with self._lock:
            payload = self._claim(sub_id)
        return None if payload is _MISSING else payload

    def _claim(self, sub_id: int):
        """Atomically retire one watch (lock held). The single claim
        point for fire / cancel / expiry — exactly-once by
        construction. Returns :data:`_MISSING` when the watch was
        unknown or already claimed (a registered payload may
        legitimately be None)."""
        loc = self._index.pop(sub_id, None)
        if loc is None:
            return _MISSING
        var_id, slot = loc
        group = self._groups[var_id]
        if not group.active[slot]:
            return _MISSING
        group.active[slot] = False
        group.retired += 1
        payload = group.payloads[slot]
        group.payloads[slot] = None
        return payload

    def _maybe_compact(self, var_id: str, group: _Group) -> None:
        """Reclaim retired slots once they dominate the group (lock
        held): rebuild the struct-of-arrays over the surviving watches
        and re-point their index entries. Without this, sustained
        threshold-read churn (every fired read retires a slot, every
        new read appends one) grows the arrays AND the evaluation
        bucket monotonically."""
        if group.retired < _MIN_CAP * 8 or group.retired * 2 < group.n:
            return
        keep = np.flatnonzero(group.active[: group.n])
        n = len(keep)
        new_cap = _next_pow2(max(n, 1))

        def packed(arr):
            out = np.zeros((new_cap,) + arr.shape[1:], dtype=arr.dtype)
            out[:n] = arr[keep]
            return out

        group.strict = packed(group.strict)
        group.replica = packed(group.replica)
        group.active = packed(group.active)
        group.leaves = [packed(leaf) for leaf in group.leaves]
        group.payloads = (
            [group.payloads[int(i)] for i in keep]
            + [None] * (new_cap - n)
        )
        group.sub_ids = packed(group.sub_ids)
        group.n = n
        group.cap = new_cap
        group.retired = 0
        for slot in range(n):
            self._index[int(group.sub_ids[slot])] = (var_id, slot)

    def rehome(self, n_replicas: int, claim_of=None,
               expire: bool = False) -> dict:
        """Membership-shrink re-homing: every ACTIVE watch whose home
        replica departed (``replica >= n_replicas``) either RE-HOMES to
        its claim successor — ``claim_of(old_row)``, defaulting to the
        ring fold ``old_row % n_replicas`` (``membership.plan.
        claim_targets`` rule: the row that received the departer's
        handoff join, so a threshold the departed row met stays met
        there) — or, with ``expire=True`` (crash/down semantics: the
        departed state is gone), retires typed through the
        exactly-once claim point.

        Returns ``{"rehomed": count, "expired": [(sub_id, payload),
        ...]}`` — expired watches are CANCELLED, never fired, and the
        caller owns their typed notifications. Never fires stale: a
        re-homed watch's next verdict reads the successor's live row,
        and evaluation's clamp-to-last-row fallback remains only a
        safety net for watches registered after this pass raced a
        shrink."""
        n_replicas = int(n_replicas)
        rehomed = 0
        expired: list = []
        with self._lock:
            for _var_id, group in self._groups.items():
                for slot in range(group.n):
                    if not group.active[slot]:
                        continue
                    old_row = int(group.replica[slot])
                    if old_row < n_replicas:
                        continue
                    if expire:
                        sub_id = int(group.sub_ids[slot])
                        payload = self._claim(sub_id)
                        if payload is not _MISSING:
                            expired.append((sub_id, payload))
                        continue
                    if claim_of is not None:
                        group.replica[slot] = int(claim_of(old_row))
                    else:
                        from ..membership.plan import claim_row

                        group.replica[slot] = claim_row(
                            old_row, n_replicas
                        )
                    rehomed += 1
        gauge(
            "serve_watch_subscriptions",
            help="threshold watches currently registered in the "
                 "subscription table",
        ).set(len(self._index))
        return {"rehomed": rehomed, "expired": expired}

    def expire(self, now: float) -> list:
        """Retire every watch whose deadline passed; returns
        ``[(sub_id, payload), ...]`` for the caller's cancellation
        notifications (deadline-expired work is CANCELLED, not
        executed)."""
        out = []
        with self._lock:
            while self._deadlines and self._deadlines[0][0] <= now:
                _dl, sub_id = heapq.heappop(self._deadlines)
                payload = self._claim(sub_id)
                if payload is not _MISSING:
                    out.append((sub_id, payload))
        return out

    def __len__(self) -> int:
        return len(self._index)

    def vars(self) -> list:
        with self._lock:
            return [v for v, g in self._groups.items() if g.n]

    # -- the vectorized pass --------------------------------------------------
    def evaluate(self, pop_of: Callable, meta_of: Callable,
                 var_ids=None) -> list:
        """ONE vectorized verdict pass per variable group: returns the
        claimed ``[(sub_id, payload), ...]`` fired watches.

        ``pop_of(var_id)`` -> the DENSE ``[R, ...]`` population pytree;
        ``meta_of(var_id)`` -> ``(codec, spec)`` (store-side). Claims
        are exactly-once (see the module doc)."""
        fired: list = []
        for var_id in (var_ids if var_ids is not None else self.vars()):
            with self._lock:
                group = self._groups.get(var_id)
                if group is None or not group.n or not group.active.any():
                    continue
                self._maybe_compact(var_id, group)
                codec, spec = meta_of(var_id)
                kernel = self._kernel_for(codec, spec)
                if kernel is None:
                    # unknown threshold_met override: reference path
                    self.pervar_fallbacks += 1
                    fired.extend(
                        self._pervar_group(group, codec, spec,
                                           pop_of(var_id))
                    )
                    continue
                n = group.n
                pop = pop_of(var_id)
                dev = tree_leaves(pop)[0].device
                thr_leaves = tuple(
                    torch.as_tensor(leaf[:n], device=dev)
                    for leaf in group.leaves
                )
                strict = torch.as_tensor(group.strict[:n], device=dev)
                valid = torch.as_tensor(group.active[:n], device=dev)
                n_replicas = int(tree_leaves(pop)[0].shape[0])
                # clamp host-side: a watch homed past a shrink re-homes to
                # the last surviving row (monotone reads stay sound at ANY
                # replica)
                rows = torch.as_tensor(
                    np.minimum(group.replica[:n], n_replicas - 1)
                    .astype(np.int64), device=dev,
                )
                tmpl = group.treedef[1] if group.treedef is not None else None
            met = kernel(pop, rows, thr_leaves, strict, valid, tmpl).cpu().numpy()
            with self._lock:
                # re-check actives under the lock: a concurrent cancel /
                # second evaluator may have claimed a slot since the
                # snapshot — the claim, not the verdict, is authoritative
                for slot in np.flatnonzero(met):
                    slot = int(slot)
                    if slot >= group.n or not group.active[slot]:
                        continue
                    sub_id = int(group.sub_ids[slot])
                    payload = self._claim(sub_id)
                    if payload is not _MISSING:
                        fired.append((sub_id, payload))
        if fired:
            self.fired_total += len(fired)
            counter(
                "serve_watch_fires_total",
                help="threshold watches fired by the vectorized "
                     "fan-out pass",
            ).inc(len(fired))
            gauge(
                "serve_watch_subscriptions",
                help="threshold watches currently registered in the "
                     "subscription table",
            ).set(len(self._index))
        return fired

    # -- per-codec kernels ----------------------------------------------------
    def _kernel_for(self, codec, spec):
        """The group-verdict function for (codec, spec), or None
        when the codec's ``threshold_met`` semantics are unknown to the
        vectorized pass (per-watch fallback)."""
        try:
            hash(spec)
            key = (codec, spec)
        except TypeError:  # unhashable spec: identity-keyed fallback
            key = (codec, id(spec))
        fn = self._kernels.get(key)
        if fn is not None:
            return fn
        from ..lattice.base import CrdtType

        name = getattr(codec, "name", "")
        if name == "riak_dt_gcounter":

            def kernel(pop, rows, thr_leaves, strict, valid, _tmpl):
                totals = _gcounter_total(pop.counts[rows])
                # JAX narrows the int64 thresholds to the counter's dtype
                # (x64 off): the same wrap, then the same compare
                thr = thr_leaves[0].to(totals.dtype)
                met = torch.where(strict, thr < totals, thr <= totals)
                return met & valid

        elif name == "lasp_ivar":

            def kernel(pop, rows, thr_leaves, strict, valid, _tmpl):
                t_def, t_val = thr_leaves
                g_def = pop.defined[rows]
                g_val = pop.value[rows]
                met_strict = ~t_def & g_def
                met_ns = (t_def == g_def) & (~t_def | (t_val == g_val))
                return torch.where(strict, met_strict, met_ns) & valid

        elif codec.threshold_met.__func__ is CrdtType.threshold_met.__func__:
            # the default (strict-)inflation rule over the gathered rows;
            # the codecs are batch-polymorphic, so one call covers [S]

            def kernel(pop, rows, thr_leaves, strict, valid, tmpl):
                gathered = tree_map(lambda x: x[rows], pop)
                thr = tree_unflatten(tmpl, list(thr_leaves))
                infl = codec.is_inflation(spec, thr, gathered)
                sinfl = codec.is_strict_inflation(spec, thr, gathered)
                return torch.where(strict, sinfl, infl) & valid

        else:
            return None
        self._kernels[key] = kernel
        return kernel

    # -- the per-watch reference path -----------------------------------------
    def evaluate_pervar(self, pop_of: Callable, meta_of: Callable,
                        var_ids=None, claim: bool = True) -> list:
        """The reference implementation: one ``codec.threshold_met``
        dispatch per active watch, exactly the store's parked-watch
        rule. The parity target the vectorized pass is tested against;
        with ``claim=False`` verdicts are reported without retiring
        (parity comparisons must not consume the watches)."""
        fired: list = []
        with self._lock:
            for var_id in (var_ids if var_ids is not None
                           else self.vars()):
                group = self._groups.get(var_id)
                if group is None or not group.n:
                    continue
                codec, spec = meta_of(var_id)
                hits = self._pervar_group(
                    group, codec, spec, pop_of(var_id), claim=claim
                )
                fired.extend(hits)
        if fired and claim:
            self.fired_total += len(fired)
        return fired

    def _pervar_group(self, group: _Group, codec, spec, pop,
                      claim: bool = True) -> list:
        pop = tree_map(lambda x: x.cpu(), pop)  # one host copy per group
        n_replicas = int(tree_leaves(pop)[0].shape[0])
        out = []
        for slot in range(group.n):
            if not group.active[slot]:
                continue
            r = min(int(group.replica[slot]), n_replicas - 1)
            row = tree_map(lambda x: x[r], pop)
            thr = group.threshold_at(slot)
            if bool(codec.threshold_met(spec, row, thr)):
                sub_id = int(group.sub_ids[slot])
                if claim:
                    payload = self._claim(sub_id)
                    if payload is _MISSING:
                        continue
                    out.append((sub_id, payload))
                else:
                    out.append((sub_id, group.payloads[slot]))
        return out
