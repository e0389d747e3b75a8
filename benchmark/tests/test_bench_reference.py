"""The plain references against the port on the CPU at tiny sizes: the
same generated writes through ``ingest_cycle`` and convergence give the
values the reference works out, and the reference's CRDTs keep their
published semantics."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark.harness import layout
from benchmark.harness.drivers import converge
from benchmark.harness.state import restore, snapshot
from benchmark.harness.traffic import Generator, by_var
from benchmark.reference import adcounter as ref_ad
from benchmark.reference import kvs as ref

from .conftest import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [1, 2**32 + 9])
def test_kvs_reference_matches_the_port(seed):
    spec = layout.load_spec()
    _cell, config, mix = tiny(spec, "kvs-zipf-burst")
    pop = layout.app_module(config).build(config, seed, CPU)
    model = ref.Store(pop.kinds, pop.specs)
    gen = Generator(pop, mix, seed, "bursts")
    load = by_var(gen.load())
    assert not pop.rt.ingest_cycle(load, isolate_errors=True)["errors"]
    converge(pop.rt, "auto")
    model.apply_cycle(load)
    snap = snapshot(pop.rt)
    for _run in range(2):
        # each run is written against the loaded store, as the burst driver's are
        restore(pop.rt, snap)
        cycle = by_var(gen.run()[0])
        report = pop.rt.ingest_cycle(cycle, isolate_errors=True)
        assert not report["errors"]
        converge(pop.rt, "auto")
        after = model.copy()
        after.apply_cycle(cycle)
        want = after.values()
        for v in pop.var_ids:
            assert pop.rt.replica_value(v, 0) == want[v], v
            assert pop.rt.replica_value(v, pop.rt.n_replicas - 1) == want[v], v


def test_adcounter_reference_matches_the_port():
    spec = layout.load_spec()
    _cell, config, _mix = tiny(spec, "adcounter-converge")
    pop = layout.app_module(config).build(config, 5, CPU)
    converge(pop.rt, "on_device")
    want = ref_ad.expected(pop.inputs)
    got = {v: pop.rt.replica_value(v, 17) for v in pop.var_ids}
    assert got == want
    assert len(want["ads"]) == 16 and len(want["active"]) == 16
    assert len(want["pairs"]) == 16 * 20


def test_orset_concurrent_field_updates_keep_the_field():
    """Two coordinators update one field at once (each an observed remove
    and an add): both new tokens live, the load's token tombstoned."""
    base = ref.ORSet({"tokens_per_actor": 2})
    base.apply(("add", "f0"), "a0")
    left, right = copy.deepcopy(base), copy.deepcopy(base)
    for view, actor in ((left, "a0"), (right, "a1")):
        view.apply(("remove", "f0"), actor)
        view.apply(("add", "f0"), actor)
    left.join(right)
    assert left.value() == {"f0"}
    assert left.tokens["f0"] == {("a0", 0): True, ("a0", 1): False, ("a1", 0): False}


def test_orset_remove_takes_only_the_tokens_it_saw():
    base = ref.ORSet({"tokens_per_actor": 2})
    base.apply(("add", "x"), "a0")
    seen = copy.deepcopy(base)
    base.apply(("add", "x"), "a1")  # unseen by the remover
    seen.apply(("remove", "x"), "a2")
    base.join(seen)
    assert base.value() == {"x"}
    with pytest.raises(OverflowError):
        for _ in range(3):
            base.apply(("add", "y"), "a0")
