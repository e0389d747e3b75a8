"""A replicated store of records: ``recordcount`` records, each a CRDT of
the configuration's ``record_type`` holding ``fieldcount`` fields of
``versions_per_field`` values each, over
``n_replicas`` replicas on a seeded topology. Each record's ``n_actors`` actors are
coordinator replicas drawn from the seed: actor ``j`` writes from one
replica only."""

from __future__ import annotations

from lasp_tpu_torch.dataflow import Graph
from lasp_tpu_torch.mesh.runtime import ReplicatedRuntime
from lasp_tpu_torch.store import Store

from benchmark.harness import clock, seeds, topology
from benchmark.harness.drivers import Population


def build(config: dict, seed: int, device) -> Population:
    n, n_actors = config["n_replicas"], config["n_actors"]
    kind = config["record_type"]
    caps = {"n_elems": config["fieldcount"] * config["versions_per_field"],
            "n_actors": n_actors, "tokens_per_actor": config["tokens_per_actor"]}
    parts = clock.Parts(device)
    store = Store(n_actors=n_actors, device=device)
    kinds, specs = {}, {}
    for i in range(config["recordcount"]):
        v = store.declare(id=f"user{i}", type=kind, **caps)
        kinds[v] = kind
        specs[v] = caps
    parts.mark("declare")
    nbrs = topology.build(config["topology"], n, seeds.sub(seed, "topology"), device)
    parts.mark("topology")
    rt = ReplicatedRuntime(store, Graph(store), n, nbrs, packed=config["packed"],
                           plan=config["plan"], device=device)
    parts.mark("runtime")
    rng = seeds.rng(seed, "coordinators")
    coordinators = {v: rng.choice(n, size=n_actors, replace=False).tolist()
                    for v in kinds}
    actors = [f"a{j}" for j in range(n_actors)]
    inputs = {"fieldcount": config["fieldcount"],
              "versions_per_field": config["versions_per_field"]}
    return Population(rt=rt, var_ids=list(kinds), inputs=inputs, kinds=kinds,
                      specs=specs,
                      coordinators=coordinators, actors=actors, parts=parts)
