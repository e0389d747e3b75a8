"""Dataflow edges: the monotone set combinators + bind_to as dense tensor
contributions (port of ``lasp_tpu.dataflow.edges``).

Reference semantics (``src/lasp_core.erl:434-712``): each combinator is a
long-lived process per input replica that re-reads its inputs and re-binds
a recomputed output (``src/lasp_process.erl:61-95``). Here an edge is a
pure function ``contribution(tables, *src_states) -> dst_state`` evaluated
for every edge in one round sweep.

- ``map`` (:639-667): output tokens indexed by *(source element, source
  token)*, so two source elements with one image never conflate their
  tokens; ``dst[d, s*T+t] = P[s, d] & src[s, t]`` with a host-built
  projection matrix ``P``.
- ``fold`` (:458-486): flat-map, the same projection with multi-target rows.
- ``filter`` (:679-712): keeps whole elements (tombstones included); same
  token space as the source, host-evaluated predicate mask.
- ``union`` (:600-627): **left-biased** ``orddict:merge``; output token space
  = concat(left tokens, right tokens).
- ``intersection`` (:544-589): membership in both dicts gates; causality =
  both token dicts (``src/lasp_lattice.erl:311-312``).
- ``product`` (:497-533): token pairs with ``deleted = XDel orelse YDel``
  (``src/lasp_lattice.erl:303-309``).
- ``bind_to`` (:434-446): identity link.

Host tables are numpy, built from the interners; :meth:`Edge.device_tables`
hands them to a round as tensors on the round's device. Every contribution
is written on the states' TRAILING axes, so one code path serves a store's
single states and a runtime's ``[R, ...]`` populations (the JAX package
writes one replica and vmaps).
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice.gset import GSetState
from ..lattice.orset import ORSetState

SET_FAMILIES = {
    "lasp_gset": "gset",
    "lasp_orset": "orset",
    "lasp_orset_gbtree": "orset",
}


def _family(type_name: str) -> str:
    try:
        return SET_FAMILIES[type_name]
    except KeyError:
        raise TypeError(
            f"set combinators require a set type, got {type_name!r} "
            "(the reference's combinators likewise only handle "
            "lasp_gset/lasp_orset, src/lasp_core.erl:497-712)"
        ) from None


def _lead(x: torch.Tensor, nd: int) -> tuple:
    """The leading (batch) dims of a leaf whose own dims are the last ``nd``."""
    return tuple(x.shape[: x.dim() - nd])


class Edge:
    """Base: host-side incremental table maintenance + a batch-polymorphic
    contribution."""

    #: variable ids read / written
    srcs: tuple = ()
    dst: str = ""
    #: combinator kind
    kind: str = "edge"
    #: ``(device, tables)`` of the last upload; dropped when refresh()
    #: changes a host table, so the steady state uploads nothing
    _tables_cache = None
    #: may this edge stack with same-signature peers in a fused propagate
    #: (``dataflow.plan``)? The fused compiler's guard sets it False on the
    #: instance when the edge's group fails to evaluate stacked; an
    #: operator may pre-poison an edge the same way
    stackable = True

    def describe(self) -> dict:
        """Provenance record: which variables feed this edge's output,
        through which combinator (:meth:`Graph.lineage` aggregates it)."""
        return {"kind": self.kind, "srcs": list(self.srcs), "dst": self.dst}

    def refresh(self, store) -> bool:
        """Fold newly interned source terms into host tables; True if
        anything changed (drives the refresh-to-fixpoint loop for chained
        edges whose universes feed each other)."""
        changed = self._refresh(store)
        if changed:
            self._tables_cache = None
            from ..telemetry import counter

            counter(
                "dataflow_edge_refreshes_total",
                help="edge table rebuilds after interner growth, by kind",
                kind=self.kind,
            ).inc()
        return changed

    def _refresh(self, store) -> bool:
        return False

    def device_tables(self, device) -> tuple:
        """The host tables as tensors on ``device``: bool masks stay bool,
        index tables become int64."""
        cached = self._tables_cache
        if cached is None or cached[0] != device:
            tables = tuple(
                torch.as_tensor(
                    t.astype(np.int64) if t.dtype != np.bool_ else t,
                    device=device,
                )
                for t in self._host_tables()
            )
            cached = self._tables_cache = (device, tables)
        return cached[1]

    def _host_tables(self) -> tuple:
        return ()

    def contribution(self, tables, *src_states):
        raise NotImplementedError

    def signature(self) -> "tuple | None":
        """Stacking signature: edges with equal signatures run the same
        contribution code over same-shaped tables and source states, so a
        fused propagate sweep evaluates them as one ``torch.func.vmap``
        over ``[G, ...]`` stacks (``dataflow.plan``). None: never stack."""
        return None


class ProjectEdge(Edge):
    """map / fold / filter — one source, host function, projection tables."""

    def __init__(self, kind: str, src: str, dst: str, fn, store):
        assert kind in ("map", "fold", "filter")
        self.kind = kind
        self.srcs = (src,)
        self.dst = dst
        self.fn = fn
        src_var = store.variable(src)
        dst_var = store.variable(dst)
        self.family = _family(src_var.type_name)
        self.src_spec = src_var.spec
        self.dst_spec = dst_var.spec
        s_cap = src_var.spec.n_elems
        # seen-by-index mask, not a position counter: product universes
        # enumerate terms in an order that changes as their inputs grow
        self._seen = np.zeros((s_cap,), dtype=bool)
        if kind == "filter":
            self._keep = np.zeros((s_cap,), dtype=bool)
        else:
            self._proj = np.zeros((s_cap, dst_var.spec.n_elems), dtype=bool)

    def _refresh(self, store) -> bool:
        src_var = store.variable(self.srcs[0])
        dst_var = store.variable(self.dst)
        if len(src_var.elems) == self._seen.sum():
            return False  # nothing interned since the last refresh
        changed = False
        for term in src_var.elems.terms():
            s = src_var.elems.index_of(term)
            if self._seen[s]:
                continue
            if self.kind == "filter":
                self._keep[s] = bool(self.fn(term))
            elif self.kind == "map":
                self._proj[s, dst_var.elems.intern(self.fn(term))] = True
            else:  # fold: flat-map, each image with the source causality
                for image in self.fn(term):
                    self._proj[s, dst_var.elems.intern(image)] = True
            self._seen[s] = True
            changed = True
        return changed

    def _host_tables(self):
        return (self._keep,) if self.kind == "filter" else (self._proj,)

    def signature(self):
        # map and fold run one contribution (only the host-built table
        # differs), so they stack together; filter is its own family
        stack_kind = "filter" if self.kind == "filter" else "proj"
        return (stack_kind, self.family, self.src_spec, self.dst_spec)

    def contribution(self, tables, src):
        (table,) = tables
        if self.family == "gset":
            if self.kind == "filter":
                return GSetState(mask=src.mask & table)
            # [..., S, 1] & [S, D] -> any over S
            return GSetState(mask=torch.any(table & src.mask[..., :, None], dim=-2))
        if self.kind == "filter":
            keep = table[:, None]
            return ORSetState(
                exists=src.exists & keep,
                removed=src.removed & src.exists & keep,
            )
        # map / fold: dst[d, s*T + t] = P[s, d] & src[s, t]
        lead = _lead(src.exists, 2)
        d_elems = self.dst_spec.n_elems
        pt = table.T[:, :, None]  # [D, S, 1]
        exists = (pt & src.exists[..., None, :, :]).reshape(lead + (d_elems, -1))
        removed = (pt & (src.removed & src.exists)[..., None, :, :]).reshape(
            lead + (d_elems, -1)
        )
        return ORSetState(exists=exists, removed=removed)


class PairwiseEdge(Edge):
    """union / intersection — two sources aligned into the output universe
    by host-built inverse-index tables (injective term-identity mappings,
    so gathers instead of projection matrices)."""

    def __init__(self, kind: str, left: str, right: str, dst: str, store):
        assert kind in ("union", "intersection")
        self.kind = kind
        self.srcs = (left, right)
        self.dst = dst
        l_var, r_var = store.variable(left), store.variable(right)
        fam_l, fam_r = _family(l_var.type_name), _family(r_var.type_name)
        if fam_l != fam_r:
            raise TypeError(f"{kind}: mixed set families {fam_l}/{fam_r}")
        self.family = fam_l
        self.l_spec, self.r_spec = l_var.spec, r_var.spec
        self.dst_spec = store.variable(dst).spec
        d_cap = self.dst_spec.n_elems
        self._inv = [np.zeros((d_cap,), dtype=np.int32) for _ in range(2)]
        self._valid = [np.zeros((d_cap,), dtype=bool) for _ in range(2)]
        l_cap, r_cap = l_var.spec.n_elems, r_var.spec.n_elems
        self._seen = [np.zeros((l_cap,), dtype=bool), np.zeros((r_cap,), dtype=bool)]

    def _refresh(self, store) -> bool:
        dst_var = store.variable(self.dst)
        changed = False
        for side, src_id in enumerate(self.srcs):
            elems = store.variable(src_id).elems
            if len(elems) == self._seen[side].sum():
                continue  # no new terms on this side
            for term in elems.terms():
                s = elems.index_of(term)
                if self._seen[side][s]:
                    continue
                if self.kind == "union" or side == 0:
                    d = dst_var.elems.intern(term)
                    self._inv[side][d] = s
                    self._valid[side][d] = True
                elif term in dst_var.elems:
                    # intersection output universe = left terms; a right
                    # term only matters if the left ever interned it
                    d = dst_var.elems.index_of(term)
                    self._inv[side][d] = s
                    self._valid[side][d] = True
                self._seen[side][s] = True
                changed = True
        if self.kind == "intersection" and changed:
            # a left term interned after its right twin: re-link the right
            r_elems = store.variable(self.srcs[1]).elems
            for d, term in enumerate(dst_var.elems.terms()):
                if not self._valid[1][d] and term in r_elems:
                    self._inv[1][d] = r_elems.index_of(term)
                    self._valid[1][d] = True
        return changed

    def _host_tables(self):
        return (self._inv[0], self._valid[0], self._inv[1], self._valid[1])

    def signature(self):
        return (self.kind, self.family, self.l_spec, self.r_spec, self.dst_spec)

    def contribution(self, tables, left, right):
        inv_l, valid_l, inv_r, valid_r = tables
        if self.family == "gset":
            lrow = left.mask[..., inv_l] & valid_l
            rrow = right.mask[..., inv_r] & valid_r
            if self.kind == "union":
                return GSetState(mask=lrow | rrow)
            return GSetState(mask=lrow & rrow)
        vl, vr = valid_l[:, None], valid_r[:, None]
        le = left.exists[..., inv_l, :] & vl
        lr = (left.removed & left.exists)[..., inv_l, :] & vl
        re_ = right.exists[..., inv_r, :] & vr
        rr = (right.removed & right.exists)[..., inv_r, :] & vr
        if self.kind == "union":
            # left-biased orddict:merge (src/lasp_core.erl:616-621): a
            # shared element's contribution carries only the left tokens,
            # so right tokens flow in only while the element is absent from
            # the left. DOCUMENTED REFERENCE DELTA (diamonds): the output
            # token axis is the concat of both sides', so a token reaching
            # the union through both inputs occupies two columns, and a
            # right-path copy absorbed in a left-absent window stays live
            # after a left-path removal (pinned by
            # tests/dataflow/test_combinators.py::test_union_diamond_frozen_copy).
            lmember = torch.any(le, dim=-1, keepdim=True)
            exists = torch.cat([le, re_ & ~lmember], dim=-1)
            removed = torch.cat([lr, rr & ~lmember], dim=-1)
        else:
            # membership in both dicts gates; causality = both token dicts
            both = (torch.any(le, dim=-1) & torch.any(re_, dim=-1))[..., None]
            exists = torch.cat([le, re_], dim=-1) & both
            removed = torch.cat([lr, rr], dim=-1) & both
        return ORSetState(exists=exists, removed=removed)


class ProductEdge(Edge):
    """Cartesian product; output element (x, y) at index lx*ER + ry, output
    token (tl, tr) at tl*TR + tr — index arithmetic, no host tables."""

    def __init__(self, left: str, right: str, dst: str, store):
        self.kind = "product"
        self.srcs = (left, right)
        self.dst = dst
        l_var, r_var = store.variable(left), store.variable(right)
        fam_l, fam_r = _family(l_var.type_name), _family(r_var.type_name)
        if fam_l != fam_r:
            raise TypeError(f"product: mixed set families {fam_l}/{fam_r}")
        self.family = fam_l
        self.l_spec, self.r_spec = l_var.spec, r_var.spec
        self.dst_spec = store.variable(dst).spec

    def signature(self):
        return ("product", self.family, self.l_spec, self.r_spec, self.dst_spec)

    def contribution(self, tables, left, right):
        del tables
        if self.family == "gset":
            lead = _lead(left.mask, 1)
            return GSetState(
                mask=(left.mask[..., :, None] & right.mask[..., None, :]).reshape(
                    lead + (-1,)
                )
            )
        lead = _lead(left.exists, 2)
        d = self.l_spec.n_elems * self.r_spec.n_elems
        le = left.exists[..., :, None, :, None]
        re_ = right.exists[..., None, :, None, :]
        lr = left.removed[..., :, None, :, None]
        rr = right.removed[..., None, :, None, :]
        both = le & re_
        exists = both.reshape(lead + (d, -1))
        # deleted = XDel orelse YDel (src/lasp_lattice.erl:303-309)
        removed = (both & (lr | rr)).reshape(lead + (d, -1))
        return ORSetState(exists=exists, removed=removed)


class BindToEdge(Edge):
    """Identity link (``src/lasp_core.erl:434-446``): dst follows src."""

    def __init__(self, src: str, dst: str, store):
        self.kind = "bind_to"
        self.srcs = (src,)
        self.dst = dst
        src_var, dst_var = store.variable(src), store.variable(dst)
        if src_var.spec != dst_var.spec:
            raise TypeError("bind_to requires identically-specced variables")
        self.spec = src_var.spec

    def signature(self):
        return ("bind_to", self.spec)

    def contribution(self, tables, src):
        del tables
        return src


__all__ = ["BindToEdge", "Edge", "PairwiseEdge", "ProductEdge", "ProjectEdge"]
