"""Pairwise replica tree exchange (port of ``lasp_tpu.aae.exchange``):
divergence detection and localization in O(log R · segments) hash
comparisons.

- :func:`exchange_pair` walks ONE replica pair's trees (columns of the
  forest's leaf / segment / root matrices): root -> divergent segments ->
  divergent leaves, counting hash comparisons (the wire unit).
- :func:`sweep` runs one anti-entropy sweep over the whole population:
  replicas pair hypercube-style (stride 1, 2, 4, ... within their
  component's member ring); the stride-1 round alone proves
  component-wide agreement when no pair diverges, the early exit.

JAX's sweep walks the pairs one by one in Python; here a stride's pairs
are compared as one numpy pass over the member ring (roots, then the
segment and leaf matrices of the pairs whose roots differ), with the same
``pairs`` order (stride by stride, then ring position, the ``stride = m/2``
duplicates dropped), the same divergent rows, rounds and comparison
counts. Pairing never crosses the chaos mask: pairs draw from the live
components (``quorum.fsm.components``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..telemetry import counter, span


def exchange_pair(forest, a: int, b: int) -> dict:
    """Walk replicas ``a`` and ``b``'s trees; returns ``{"divergent":
    [var_id, ...], "comparisons": int}`` (empty when the roots agree — the
    1-comparison fast path)."""
    comparisons = 1
    if forest.roots[a] == forest.roots[b]:
        return {"divergent": [], "comparisons": comparisons}
    seg = forest.segmat
    diff_segs = np.flatnonzero(seg[:, a] != seg[:, b])
    comparisons += int(seg.shape[0])
    leaf = forest.leaf_matrix()
    order = forest.var_order
    divergent: list = []
    for s in diff_segs:
        lo = int(s) * forest.seg
        hi = min(lo + forest.seg, leaf.shape[0])
        comparisons += hi - lo
        for vi in range(lo, hi):
            if leaf[vi, a] != leaf[vi, b]:
                divergent.append(order[vi])
    return {"divergent": divergent, "comparisons": comparisons}


def _component_members(components: "np.ndarray | None",
                       live: np.ndarray) -> list:
    """Sorted member arrays of every live component with >= 2 members, in
    the order of each component's lowest live member."""
    rows = np.flatnonzero(live)
    if components is None:
        return [rows] if rows.size >= 2 else []
    labels = np.asarray(components)[rows]
    _u, first, inverse = np.unique(labels, return_index=True,
                                   return_inverse=True)
    order = np.argsort(first, kind="stable")
    by_group = np.argsort(inverse, kind="stable")  # rows stay ascending
    bounds = np.cumsum(np.bincount(inverse, minlength=first.size))
    starts = bounds - np.bincount(inverse, minlength=first.size)
    out = []
    for g in order:
        members = rows[by_group[starts[g]:bounds[g]]]
        if members.size >= 2:
            out.append(members)
    return out


@dataclasses.dataclass
class SweepArrays:
    """One sweep's result as arrays: the divergent pairs in JAX's order
    (``a``, ``b``), their divergent variables (``div: bool[P, V]`` in the
    forest's ``var_order``), and the counts."""

    a: np.ndarray
    b: np.ndarray
    div: np.ndarray
    var_order: tuple
    rounds: int
    comparisons: int
    components: int
    n_replicas: int = 0
    _rows: "dict | None" = None

    def divergent_rows(self) -> dict:
        """{var_id: sorted rows}, keyed in order of first divergence
        (computed once)."""
        if self._rows is not None:
            return self._rows
        out = {}
        if self.a.size:
            n = max(self.n_replicas, int(max(self.a.max(), self.b.max())) + 1)
            first = np.where(self.div.any(axis=0), self.div.argmax(axis=0),
                             self.div.shape[0])
            for vi in np.argsort(first, kind="stable"):
                if first[vi] == self.div.shape[0]:
                    continue
                col = self.div[:, vi]
                seen = np.zeros(n, dtype=bool)
                seen[self.a[col]] = True
                seen[self.b[col]] = True
                out[self.var_order[vi]] = np.flatnonzero(seen).tolist()
        self._rows = out
        return out

    def n_divergent_rows(self) -> int:
        return sum(len(rs) for rs in self.divergent_rows().values())

    def pairs(self) -> list:
        """JAX's ``[(a, b, [var_id, ...]), ...]``."""
        order = self.var_order
        return [
            (int(a), int(b), [order[vi] for vi in np.flatnonzero(row)])
            for a, b, row in zip(self.a, self.b, self.div)
        ]


def _stride_pairs(forest, members: np.ndarray, stride: int):
    """One stride's exchanges over a member ring: ``(a, b, div bool[P, V],
    comparisons)`` for the pairs that diverge, in ring order."""
    m = members.size
    i = np.arange(m // 2 if 2 * stride == m else m)
    a = members[i]
    b = members[(i + stride) % m]
    roots = forest.roots
    hot = np.flatnonzero(roots[a] != roots[b])
    comparisons = int(i.size)
    leaf = forest.leaf_matrix()
    v = leaf.shape[0]
    if not hot.size:
        return a[:0], b[:0], np.zeros((0, v), dtype=bool), comparisons
    a, b = a[hot], b[hot]
    seg = forest.segmat
    ns = seg.shape[0]
    seg_diff = seg[:, a] != seg[:, b]  # [NS, P]
    comparisons += ns * int(hot.size)
    # every differing segment's leaves are compared (the last one may be
    # short); only leaves inside a differing segment can be reported
    seg_len = np.minimum(forest.seg, v - np.arange(ns) * forest.seg)
    comparisons += int((seg_diff * seg_len[:, None]).sum())
    in_diff = np.repeat(seg_diff, forest.seg, axis=0)[:v]  # [V, P]
    div = ((leaf[:, a] != leaf[:, b]) & in_diff).T  # [P, V]
    keep = div.any(axis=1)
    return a[keep], b[keep], div[keep], comparisons


def sweep_arrays(forest, components: "np.ndarray | None" = None,
                 live: "np.ndarray | None" = None) -> SweepArrays:
    """One anti-entropy sweep as :class:`SweepArrays` (see :func:`sweep`)."""
    n = forest.leaf_matrix().shape[1]
    if live is None:
        live = np.ones(n, dtype=bool)
    live = np.asarray(live, dtype=bool)
    v = forest.leaf_matrix().shape[0]
    parts_a, parts_b, parts_div = [], [], []
    rounds = 0
    comparisons = 0
    with span("aae.exchange"):
        groups = _component_members(components, live)
        for members in groups:
            m = members.size
            stride = 1
            sweep_rounds = 0
            while stride < m:
                sweep_rounds += 1
                a, b, div, comps = _stride_pairs(forest, members, stride)
                comparisons += comps
                parts_a.append(a)
                parts_b.append(b)
                parts_div.append(div)
                if stride == 1 and not a.size:
                    # adjacent equality around the member ring is
                    # transitive: the whole component agrees
                    break
                stride *= 2
            rounds = max(rounds, sweep_rounds)
    out = SweepArrays(
        a=np.concatenate(parts_a) if parts_a else np.zeros(0, np.int64),
        b=np.concatenate(parts_b) if parts_b else np.zeros(0, np.int64),
        div=(np.concatenate(parts_div) if parts_div
             else np.zeros((0, v), dtype=bool)),
        var_order=tuple(forest.var_order), rounds=rounds,
        comparisons=comparisons, components=len(groups), n_replicas=n,
    )
    counter(
        "aae_exchange_rounds_total",
        help="hypercube pairing rounds executed by AAE sweeps",
    ).inc(rounds)
    if out.a.size:
        counter(
            "aae_divergent_rows_total",
            help="(var, row) divergences localized by AAE tree "
                 "exchanges",
        ).inc(out.n_divergent_rows())
    return out


def sweep(forest, components: "np.ndarray | None" = None,
          live: "np.ndarray | None" = None) -> dict:
    """One anti-entropy sweep (see the module doc). Returns::

        {"divergent": {var_id: sorted row list},
         "pairs": [(a, b, [vars...]), ...],
         "rounds": int, "comparisons": int, "components": int}

    ``components`` is an ``int[R]`` labeling (None = fully connected);
    ``live`` masks crashed rows out of the pairing entirely."""
    sw = sweep_arrays(forest, components, live)
    return {
        "divergent": sw.divergent_rows(),
        "pairs": sw.pairs(),
        "rounds": sw.rounds,
        "comparisons": sw.comparisons,
        "components": sw.components,
    }
