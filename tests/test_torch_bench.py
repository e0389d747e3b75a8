"""The port's headline scenario, ``bench_scenarios.orset_anti_entropy``,
against ``lasp_tpu``'s at 256 replicas with a narrow spec: the same seeding
and topology must give the same rounds to convergence and the same
productive rounds per fused block. Only counts are compared; a time taken
on the CPU says nothing about the card."""

import pytest
import torch

import lasp_tpu.bench_scenarios as jb
import lasp_tpu_torch.bench_scenarios as tb

# Tiny CPU shapes: torch's intra-op threads only add synchronisation here,
# and under a parallel test run they oversubscribe the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("fanout,block,seed", [(3, 4, 7), (2, 3, 1)])
def test_orset_anti_entropy_counts_match_jax(fanout, block, seed):
    kw = dict(fanout=fanout, block=block, seed=seed, n_elems=8, n_actors=4,
              tokens_per_actor=2, timing_reps=1)
    want = jb.orset_anti_entropy(256, **kw)
    got = tb.orset_anti_entropy(256, device="cpu", **kw)
    assert got["rounds"] == want["rounds"] > 1
    assert (got["convergence"]["productive_rounds_per_block"]
            == want["convergence"]["productive_rounds_per_block"])
    assert (got["convergence"]["diverged_replicas_at_seed"]
            == want["convergence"]["diverged_replicas_at_seed"])
    assert got["state_bytes_per_replica"] == want["state_bytes_per_replica"]
    assert got["check"] == want["check"] == "converged+all-live"
    # the bytes model of one round: (K + 2) rows of both planes per replica
    assert got["bytes_moved"] == (
        (fanout + 2) * 256 * got["state_bytes_per_replica"] * got["rounds"]
    )
    assert got["device"] == "cpu" and got["gossip_impl"] == "plain"


def test_adcounter_north_star_matches_jax():
    """The north star at 8,192 replicas: the same rounds (warm round
    included), view totals, live ads, active pairs and bytes a replica."""
    want = jb.adcounter_10m(8192, threshold=5)
    got = tb.adcounter_10m(8192, threshold=5, device="cpu")
    for key in ("scenario", "rounds", "ad_totals", "live_ads", "active_pairs",
                "state_bytes_per_replica", "engine", "check"):
        assert got[key] == want[key], key
    assert got["rounds"] > 2 and got["state_bytes_per_replica"] == 416
    assert got["driver"].startswith("converge_on_device(fused blocks")


def test_adcounter_6_matches_jax():
    want = jb.adcounter_6()
    got = tb.adcounter_6(device="cpu")
    for key in ("scenario", "rounds", "totals", "engine", "check"):
        assert got[key] == want[key], key
