"""The YCSB generator against the plain reference: every run replays
without a precondition or capacity error, writes only at each record's
coordinators, keeps the workload's proportions, and every seed sends the
same sizes."""

from __future__ import annotations

import collections
import numpy as np
import pytest

from benchmark.harness import layout, seeds
from benchmark.harness.drivers import Population
from benchmark.harness.traffic import Generator, by_var, split, zipf_counts
from benchmark.reference import kvs as ref


class _Rt:
    n_replicas = 100_000


def _population(mix_over=None, seed=3):
    spec = layout.load_spec()
    cell = layout.find_cell(spec, "kvs-zipf-burst")
    config = layout.config_of(spec, cell)
    mix = {**layout.traffic_of(cell), **(mix_over or {})}
    caps = {"n_elems": config["fieldcount"] * config["versions_per_field"],
            "n_actors": config["n_actors"],
            "tokens_per_actor": config["tokens_per_actor"]}
    names = [f"user{i}" for i in range(config["recordcount"])]
    rng = seeds.rng(seed, "coordinators")
    coord = {v: rng.choice(_Rt.n_replicas, size=config["n_actors"],
                           replace=False).tolist() for v in names}
    inputs = {k: config[k] for k in ("fieldcount", "versions_per_field")}
    pop = Population(rt=_Rt(), var_ids=names, inputs=inputs,
                     kinds={v: config["record_type"] for v in names},
                     specs={v: caps for v in names}, coordinators=coord,
                     actors=[f"a{j}" for j in range(config["n_actors"])])
    return pop, mix


def test_zipf_counts_sum_and_shape():
    c = zipf_counts(128, 500, 0.99)
    assert c.sum() == 500
    assert (np.diff(c) <= 0).all()
    w = 1 / np.arange(1, 129) ** 0.99
    assert c[0] == round(500 * w[0] / w.sum())


def test_split_keeps_the_proportions():
    assert split(1000, [0.5, 0.5]) == [500, 500]
    assert split(1001, [0.95, 0.05]) == [951, 50]


def _fields(value) -> dict:
    out = {}
    for elem in value:
        f, ver = elem.split(".")
        out.setdefault(f, set()).add(ver)
    return out


@pytest.mark.parametrize("seed", [5, 2**33 + 1, 991])
def test_runs_replay_under_the_plain_semantics(seed):
    """The load and each run apply without a precondition or capacity
    error, every update at its actor's coordinator, the proportions and
    the operation count kept; every field keeps a value, and a field
    some coordinator updated holds that coordinator's last version."""
    pop, mix = _population()
    model = ref.Store(pop.kinds, pop.specs)
    gen = Generator(pop, mix, seed, "bursts")
    model.apply_cycle(by_var(gen.load()))
    n_fields = pop.inputs["fieldcount"]
    loaded = {f"f{f}": {"v0"} for f in range(n_fields)}
    assert all(_fields(model.values()[v]) == loaded for v in pop.var_ids)
    for _run in range(3):
        updates, reads = gen.run()
        assert len(updates) // 2 + len(reads) == mix["operationcount"]
        assert len(reads) == round(mix["readproportion"] * mix["operationcount"])
        last = {}
        for (v, r, op, a), (v2, r2, op2, a2) in zip(updates[::2], updates[1::2]):
            assert (v, r, a) == (v2, r2, a2)
            assert (op[0], op2[0]) == ("remove", "add")
            assert op[1].split(".")[0] == op2[1].split(".")[0] and op[1] != op2[1]
            assert pop.coordinators[v][pop.actors.index(a)] == r
            last[(v, op2[1].split(".")[0], a)] = op2[1].split(".")[1]
        assert all(0 <= r < _Rt.n_replicas for _v, r in reads)
        store = model.copy()
        store.apply_cycle(by_var(updates))
        got = store.values()
        for v in pop.var_ids:
            want = {f: {ver for (w, g, _a), ver in last.items() if (w, g) == (v, f)}
                    or {"v0"} for f in loaded}
            assert _fields(got[v]) == want, v
        assert any(_fields(got[v]) != loaded for v in pop.var_ids)


def test_same_sizes_for_every_seed():
    pop, mix = _population()
    sizes = []
    for seed in (11, 12):
        updates, reads = Generator(pop, mix, seed, "bursts").run()
        per = collections.Counter(v for v, *_ in updates[::2])
        per_read = collections.Counter(v for v, _r in reads)
        sizes.append((sorted(per.values()), sorted(per_read.values())))
    assert sizes[0] == sizes[1]


def test_each_version_is_added_once_a_run():
    pop, mix = _population()
    gen = Generator(pop, mix, 7, "bursts")
    minted = collections.Counter((v, op[1]) for v, _r, op, _a in gen.run()[0]
                                 if op[0] == "add")
    assert max(minted.values()) == 1 <= pop.specs["user0"]["tokens_per_actor"]
    versions = {int(e.split(".v")[1]) for _v, e in minted}
    assert max(versions) < pop.inputs["versions_per_field"]


def test_too_few_versions_are_refused():
    pop, mix = _population()
    pop.inputs = {**pop.inputs, "versions_per_field": 4}
    with pytest.raises(ValueError, match="versions"):
        Generator(pop, mix, 1, "bursts")


def test_seeds_take_any_whole_number():
    assert seeds.sub(2**31 + 5, "x") != seeds.sub(2**31 + 6, "x")
    assert seeds.sub(2**63 + 5, "x") >= 0
