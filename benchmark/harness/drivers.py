"""The general drivers of a window, one per kind of traffic; a mix names
its driver and gives its parameters (``traffic/<mix>.json``).

- ``replay`` (closed loop): the population was written in set-up; each
  iteration restores the set-up snapshot with the harness's own device
  copy, outside the timed part, then converges it.
- ``burst`` (closed loop): each iteration is one run of a YCSB workload
  (``harness.traffic``) against the loaded store, restored outside the
  timed part as YCSB's run phase follows its load: the updates through
  ``ingest_cycle``, convergence, then the reads.

Every iteration's converged population is kept as a digest for the check,
outside the timed part where the loop is closed."""

from __future__ import annotations

import dataclasses
import time

from . import clock, seeds
from .state import Digest, restore, snapshot
from .traffic import Generator, by_var


@dataclasses.dataclass
class Population:
    """What a configuration's builder hands the driver: the runtime, the
    variables the check reads, and the plain inputs the reference is
    given. A store also names each variable's kind, widths, coordinators
    and actors for the traffic generator."""

    rt: object
    var_ids: list
    inputs: dict = dataclasses.field(default_factory=dict)
    kinds: "dict | None" = None
    specs: "dict | None" = None
    coordinators: "dict | None" = None
    actors: "list | None" = None
    parts: object = None


@dataclasses.dataclass
class Records:
    """What the window recorded for the per-layer readers."""

    rounds: list = dataclasses.field(default_factory=list)
    seconds: list = dataclasses.field(default_factory=list)
    ingest_s: list = dataclasses.field(default_factory=list)
    ingest_ops: list = dataclasses.field(default_factory=list)
    read_s: list = dataclasses.field(default_factory=list)
    read_ops: list = dataclasses.field(default_factory=list)


def converge(rt, how: str) -> int:
    """Run the population to quiescence; the exact rounds it took."""
    if how == "on_device":
        return rt.converge_on_device()
    if how == "auto":
        return rt.run_to_convergence(mode="auto")
    raise ValueError(f"unknown convergence {how!r}")


def fits(deadline: float, last: float) -> bool:
    """Whether another iteration fits the window: at the pace of the last
    one it would end by the window's close. A window runs whole
    iterations, at least one, and ends at most about one iteration short
    of its seconds, traced or not, so a traced run, whose iterations the
    profiler slows, runs fewer and reads its trace within its time."""
    return time.perf_counter() + last <= deadline


def count_errors(report: dict, cycle: dict) -> int:
    return sum(len(cycle[v]) for v in report["errors"])


class Driver:
    def __init__(self, pop: Population, mix: dict, seed: int, device, reference,
                 tracer, spans: bool = False):
        self.pop, self.mix, self.seed = pop, mix, seed
        self.device, self.reference, self.tracer = device, reference, tracer
        self.spans = spans
        self.records = Records()

    def _converge(self) -> int:
        return converge(self.pop.rt, self.mix["converge"])

    def _ingest(self, cycle: dict) -> int:
        """One cycle through the write path; the ops that failed. Under
        ``spans`` the write path's own span closes on a synchronize."""
        rt = self.pop.rt
        t0 = time.perf_counter()
        report = rt.ingest_cycle(cycle, isolate_errors=True)
        if self.spans:
            clock.sync(self.device)
            self.records.ingest_s.append(time.perf_counter() - t0)
            self.records.ingest_ops.append(sum(len(o) for o in cycle.values()))
        return count_errors(report, cycle)

    def _sample(self, n_items: int) -> list:
        """Indices of the iterations whose values the check reads: a
        seeded sample, the last always among them."""
        if n_items == 0:
            return []
        k = min(self.mix.get("checked", 4), n_items)
        rng = seeds.rng(self.seed, "checked")
        picked = set(rng.choice(n_items - 1, size=max(k - 1, 0), replace=False)
                     .tolist()) if n_items > 1 else set()
        return sorted(picked | {n_items - 1})


class Replay(Driver):
    def warm(self) -> None:
        rt, parts = self.pop.rt, self.pop.parts
        self.snap = snapshot(rt)
        parts.mark("snapshot")
        # one block of the loop (8 rounds) runs every kernel and operator
        # an iteration runs; each iteration restores the population first
        rt.converge_on_device(max_rounds=8, strict=False)
        parts.mark("warm_block")

    def run(self, seconds: float) -> dict:
        rt, rec, self.digests = self.pop.rt, self.records, []
        deadline = time.perf_counter() + seconds
        while True:
            restore(rt, self.snap)
            with self.tracer.iteration():
                rounds, secs = clock.timed(self.device, self._converge)
            rec.rounds.append(rounds)
            rec.seconds.append(secs)
            self.digests.append(Digest(rt, self.pop.var_ids))
            if not fits(deadline, secs):
                break
        return {"metrics": {"converge_s": sum(rec.seconds) / len(rec.seconds)},
                "attempted": len(rec.seconds), "failed": 0}

    def check(self) -> list:
        rt = self.pop.rt
        apart = sum(len(d.rows_apart()) for d in self.digests)
        unequal = sum(len(d.same_as(self.digests[0])) for d in self.digests[1:])
        want = self.reference.expected(self.pop.inputs)
        rng = seeds.rng(self.seed, "replicas")
        replicas = sorted({0, rt.n_replicas - 1, *rng.integers(
            0, rt.n_replicas, size=self.mix.get("replicas_checked", 2)).tolist()})
        wrong = sum(rt.replica_value(v, r) != want[v]
                    for v in self.pop.var_ids for r in replicas)
        return [("rows_apart", apart, 0), ("runs_unequal", unequal, 0),
                ("values_wrong", wrong, 0)]


class Burst(Driver):
    """Set-up: the load, converged and snapshotted. The load is the
    warm-up: it runs every kernel and operator a burst runs (eager PyTorch
    and the port's prebuilt kernels compile nothing for a new size).

    Each iteration is one run of the workload against the loaded store
    (restored outside the timed part): its updates through
    ``ingest_cycle``, convergence to quiescence, then its reads, each at
    its replica."""

    def warm(self) -> None:
        pop, parts = self.pop, self.pop.parts
        self.model = self.reference.Store(pop.kinds, pop.specs)
        self.gen = Generator(pop, self.mix, self.seed, "bursts")
        load = by_var(self.gen.load())
        parts.mark("load_ops")
        self.failed = self._ingest(load)
        self._converge()
        self.model.apply_cycle(load)
        self.snap = snapshot(pop.rt)
        parts.mark("load")
        self.records = type(self.records)()

    def _read(self, reads) -> list:
        rt = self.pop.rt
        t0 = time.perf_counter()
        answers = [rt.replica_value(v, r) for v, r in reads]
        if self.spans:
            self.records.read_s.append(time.perf_counter() - t0)
            self.records.read_ops.append(len(reads))
        return answers

    def run(self, seconds: float) -> dict:
        rt, mix, rec = self.pop.rt, self.mix, self.records
        self.bursts = []
        deadline = time.perf_counter() + seconds
        while True:
            updates, reads = self.gen.run()
            cycle = by_var(updates)
            restore(rt, self.snap)

            def burst():
                failed = self._ingest(cycle)
                rounds = self._converge()
                return failed, rounds, self._read(reads)

            with self.tracer.iteration():
                (failed, rounds, answers), secs = clock.timed(self.device, burst)
            self.failed += failed
            rec.rounds.append(rounds)
            rec.seconds.append(secs)
            self.bursts.append((cycle, Digest(rt, self.pop.var_ids), reads, answers))
            if not fits(deadline, secs):
                break
        return {"metrics": {"burst_s": sum(rec.seconds) / len(rec.seconds)},
                "attempted": len(rec.seconds) * mix["operationcount"],
                "failed": self.failed}

    def check(self) -> list:
        """Every burst's replicas bit-equal; every read's answer the
        reference's value of its record after its burst; a seeded sample
        of bursts (the last among them) read back whole."""
        rt = self.pop.rt
        apart = sum(len(d.rows_apart()) for _c, d, _r, _a in self.bursts)
        reads_wrong = values_wrong = 0
        sampled = set(self._sample(len(self.bursts)))
        for i, (cycle, digest, reads, answers) in enumerate(self.bursts):
            store = self.model.copy()
            store.apply_cycle(cycle)
            want = store.values()
            reads_wrong += sum(a != want[v] for (v, _r), a in zip(reads, answers))
            if i in sampled:
                got = digest.values(rt, rt.replica_value)
                values_wrong += sum(got[v] != want[v] for v in self.pop.var_ids)
        return [("rows_apart", apart, 0), ("values_wrong", values_wrong, 0),
                ("reads_wrong", reads_wrong, 0), ("ops_failed", self.failed, 0)]


DRIVERS = {"replay": Replay, "burst": Burst}
