"""Lasp's advertisement counter (``riak_test/
lasp_advertisement_counter_test.erl:65-235``), set up as
``lasp_tpu_torch.bench_scenarios.adcounter_setup`` sets it up, with the
topology and the views' assignment drawn from the seed.

The publishers and the contracts' server write from the three replicas
most pulled from, the gossip graph's hubs, as ``scale_free``'s lowest
indices are in ``adcounter_setup``. Two publishers' OR-Sets of ads are
unioned, producted with the contracts
and filtered to the matching pairs; every ad has a G-Counter of views; a
server trigger removes an ad from its publisher's set at any replica that
sees its views at the threshold. Replica ``r`` views ad ``q % n_ads`` in
lane ``(q // n_ads) % n_lanes`` for ``q = perm[r]``, and ad ``a`` has
``lanes_per_ad[a]`` lanes that count, a seeded order of the same counts
for every seed; each lane is one actor incremented once by each of its
replicas, so an ad's total converges to its number of lanes."""

from __future__ import annotations

import numpy as np
import torch

from lasp_tpu_torch.dataflow import Graph
from lasp_tpu_torch.mesh.runtime import ReplicatedRuntime
from lasp_tpu_torch.store import Store

from benchmark.harness import clock, seeds, topology
from benchmark.harness.drivers import Population


def _assignment(n: int, n_ads: int, n_lanes: int, seed: int, device) -> tuple:
    """``(ad_of_r, lane_of_r)`` for every replica, from a seeded
    permutation made on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.sub(seed, "views"))
    q = torch.randperm(n, generator=gen, device=device)
    return ((q % n_ads).cpu().numpy(), ((q // n_ads) % n_lanes).cpu().numpy())


def build(config: dict, seed: int, device) -> Population:
    n = config["n_replicas"]
    n_pub, n_contracts, n_lanes = (config["ads_per_publisher"],
                                   config["contracts"], config["view_lanes"])
    threshold = config["threshold"]
    n_ads = 2 * n_pub
    parts = clock.Parts(device)
    rng = seeds.rng(seed, "adcounter")
    lanes_per_ad = rng.permutation(np.asarray(config["lanes_per_ad"], dtype=np.int64))

    store = Store(n_actors=1, device=device)
    graph = Graph(store)
    ads_a = store.declare(id="ads_a", type="lasp_orset", n_elems=n_pub, n_actors=1,
                          tokens_per_actor=1)
    ads_b = store.declare(id="ads_b", type="lasp_orset", n_elems=n_pub, n_actors=1,
                          tokens_per_actor=1)
    contracts = store.declare(id="contracts", type="lasp_orset", n_elems=n_contracts,
                              n_actors=1, tokens_per_actor=1)
    ads = graph.union(ads_a, ads_b, dst="ads")
    pairs = graph.product(ads, contracts, dst="pairs")
    # a contract covers the ads whose index hashes onto it
    graph.filter(
        pairs, lambda xy: int(xy[0][2:]) % n_contracts == int(xy[1][1:]), dst="active"
    )
    views = [store.declare(id=f"views_{a}", type="riak_dt_gcounter", n_actors=n_lanes)
             for a in range(n_ads)]
    parts.mark("declare")
    nbrs = topology.build(config["topology"], n, seeds.sub(seed, "topology"), device)
    publishers = topology.most_pulled(nbrs, 3)
    parts.mark("topology")
    rt = ReplicatedRuntime(store, graph, n, nbrs, packed=config["packed"], device=device)
    del nbrs
    parts.mark("runtime")

    rt.update_batch(ads_a, [(publishers[0],
                             ("add_all", [f"ad{i}" for i in range(n_pub)]), "pub_a")])
    rt.update_batch(ads_b, [(publishers[1],
                             ("add_all", [f"ad{i + n_pub}" for i in range(n_pub)]),
                             "pub_b")])
    rt.update_batch(contracts, [(publishers[2],
                                 ("add_all", [f"c{j}" for j in range(n_contracts)]),
                                 "srv")])

    parts.mark("publishers")
    ad_of_r, lane_of_r = _assignment(n, n_ads, n_lanes, seed, device)
    valid = lane_of_r < lanes_per_ad[ad_of_r]
    rows = np.arange(n)
    for a in range(n_ads):
        sel = valid & (ad_of_r == a)
        rt.seed_increments(views[a], rows[sel], lane_of_r[sel])
    seeded = np.unique(ad_of_r[valid] * n_lanes + lane_of_r[valid])
    del rows, valid, ad_of_r, lane_of_r
    parts.mark("views")

    # the server, written for one replica (the runtime vmaps it): each
    # publisher's mask gathers the over-threshold flags through an
    # element -> ad table whose last slot is a constant False
    def make_server():
        a_idx = rt.intern_terms(ads_a, [f"ad{i}" for i in range(n_pub)])
        b_idx = rt.intern_terms(ads_b, [f"ad{i + n_pub}" for i in range(n_pub)])
        sides = []
        for vid, idx, sl in ((ads_a, a_idx, slice(0, n_pub)),
                             (ads_b, b_idx, slice(n_pub, n_ads))):
            table = np.full(n_pub, n_pub, dtype=np.int64)
            table[idx] = np.arange(n_pub)
            sides.append((vid, torch.as_tensor(table, device=device), sl))
        never = torch.zeros((1,), dtype=torch.bool, device=device)

        def server(dense):
            totals = torch.stack(
                [torch.sum(dense[v].counts, dtype=torch.int32) for v in views]
            )
            over = totals >= threshold
            out = {}
            for vid, table, sl in sides:
                st = dense[vid]
                mask = torch.cat([over[sl], never])[table]
                out[vid] = st._replace(removed=st.removed | (st.exists & mask[:, None]))
            return out

        return server

    rt.register_trigger(builder=make_server, touches=[ads_a, ads_b, *views])
    parts.mark("trigger")
    inputs = {"ads_per_publisher": n_pub, "contracts": n_contracts,
              "view_lanes": n_lanes, "threshold": threshold,
              "seeded_views": seeded}
    return Population(rt=rt, var_ids=[ads_a, ads_b, contracts, ads, pairs, "active",
                                      *views], inputs=inputs, parts=parts)
