"""The general generator of a YCSB core workload over a replicated store of
records.

A traffic mix (``traffic/<mix>.json``) gives the workload's properties as
YCSB's ``workloads/`` files name them (``operationcount``,
``readproportion``, ``updateproportion``, ``zipfian_constant``); the
configuration gives the records: each is a ``lasp_orset`` of its
fields' values, written by its coordinators, actor ``j`` from one
replica only (riak_dt's one actor, one writer), so every acknowledged
write lands in the converged value.

- The load inserts every record with every field at version 0, field
  ``f`` by coordinator ``f % n``.
- A run is ``operationcount`` ops. Keys are Zipfian over popularity ranks
  (YCSB's scrambled Zipfian: a seeded map from rank to record); the reads
  and the updates a rank gets are fixed by the weights (largest
  remainders), so every seed sends the same sizes in another order.
- An update writes one field (YCSB's ``writeallfields=false``) with a new
  value: a field's values are ``versions_per_field`` elements of the
  record's OR-Set, ``f<i>.v0`` the load's, and an update at a coordinator
  is an observed remove of the version it holds and an add of a version
  no actor has written this run (actor ``j``'s ``k``-th update of a field
  writes version ``1 + j * m + k``, ``m`` versions an actor). A record's
  updates go round its ``(field, coordinator)`` pairs in a seeded order,
  so no pair takes more than ``ceil(updates / pairs)`` of them a run, and
  each version is added once a run by one actor: one token each.
- A read (``readallfields=true``) asks one seeded replica for the whole
  record.

Every run is written against the loaded store (the driver restores it),
as YCSB's run phase follows its load phase.
"""

from __future__ import annotations

import math

import numpy as np

from . import seeds


def zipf_counts(n_ranks: int, n_ops: int, exponent: float) -> np.ndarray:
    """Ops per popularity rank, summing to ``n_ops``: the Zipf weights'
    shares, rounded by largest remainders."""
    w = 1.0 / np.arange(1, n_ranks + 1, dtype=np.float64) ** exponent
    share = w / w.sum() * n_ops
    counts = np.floor(share).astype(np.int64)
    short = n_ops - int(counts.sum())
    counts[np.argsort(-(share - counts), kind="stable")[:short]] += 1
    return counts


def split(total: int, proportions: list) -> list:
    """``total`` ops split by ``proportions`` (largest remainders)."""
    share = np.asarray(proportions, dtype=np.float64) * total
    counts = np.floor(share).astype(np.int64)
    short = total - int(counts.sum())
    counts[np.argsort(-(share - counts), kind="stable")[:short]] += 1
    return counts.tolist()


class Generator:
    """The load and the runs of one YCSB workload, from one seed.

    ``run()`` gives ``(updates, reads)``: updates as ``(record, replica,
    op, actor)`` in the order they are sent, reads as ``(record,
    replica)``."""

    def __init__(self, pop, mix: dict, seed: int, tag: str):
        self.pop = pop
        self.mix = mix
        self.rng = seeds.rng(seed, f"traffic/{tag}")
        self.order = [pop.var_ids[i] for i in self.rng.permutation(len(pop.var_ids))]
        n_ops = mix["operationcount"]
        self.n_reads, self.n_updates = split(
            n_ops, [mix["readproportion"], mix["updateproportion"]])
        if self.n_reads + self.n_updates != n_ops:
            raise ValueError("traffic: readproportion and updateproportion must "
                             "sum to 1")
        self.updates_per_rank = zipf_counts(len(self.order), self.n_updates,
                                            mix["zipfian_constant"])
        self.reads_per_rank = zipf_counts(len(self.order), self.n_reads,
                                          mix["zipfian_constant"])
        self.n_fields = pop.inputs["fieldcount"]
        n_act = len(pop.actors)
        self.per_actor = (pop.inputs["versions_per_field"] - 1) // n_act
        need = math.ceil(int(self.updates_per_rank.max()) / (self.n_fields * n_act))
        if need > self.per_actor:
            raise ValueError(f"traffic: a run updates a field at one coordinator "
                             f"up to {need} times; the versions give each actor "
                             f"{self.per_actor}")

    def load(self) -> list:
        """Every record with every field at version 0, as ``(record,
        replica, op, actor)``."""
        pop, n_act = self.pop, len(self.pop.actors)
        return [(v, pop.coordinators[v][f % n_act], ("add", f"f{f}.v0"),
                 pop.actors[f % n_act])
                for v in pop.var_ids for f in range(self.n_fields)]

    def run(self) -> tuple:
        pop, rng = self.pop, self.rng
        n_act = len(pop.actors)
        kinds = rng.permutation(np.repeat(
            np.arange(2 * len(self.order)),
            np.concatenate([self.updates_per_rank, self.reads_per_rank])))
        turns = {}  # record -> [its pairs in a seeded order, updates so far]
        held = {}  # (record, field, actor) -> the version that actor holds
        written = {}  # (record, field, actor) -> versions it wrote this run
        updates, reads = [], []
        for k in kinds.tolist():
            v = self.order[k % len(self.order)]
            if k >= len(self.order):
                reads.append((v, int(rng.integers(0, pop.rt.n_replicas))))
                continue
            if v not in turns:
                turns[v] = [rng.permutation(self.n_fields * n_act).tolist(), 0]
            pairs, i = turns[v]
            turns[v][1] += 1
            f, j = divmod(pairs[i % len(pairs)], n_act)
            key = (v, f, j)
            new = 1 + j * self.per_actor + written.get(key, 0)
            written[key] = written.get(key, 0) + 1
            replica, actor = pop.coordinators[v][j], pop.actors[j]
            updates.append((v, replica, ("remove", f"f{f}.v{held.get(key, 0)}"), actor))
            updates.append((v, replica, ("add", f"f{f}.v{new}"), actor))
            held[key] = new
        return updates, reads


def by_var(ops) -> dict:
    """One cycle's ops as ``ingest_cycle`` takes them: ``{var: [(replica,
    op, actor), ...]}``, each variable's order kept."""
    cycle: dict = {}
    for v, replica, op, actor in ops:
        cycle.setdefault(v, []).append((replica, op, actor))
    return cycle
