"""``run_harness`` of the port's chaos layer against ``lasp_tpu.chaos``'s
over the preset matrix (every preset, ring and random-regular topologies,
dense and frontier scheduling): the same reports (rounds, rounds to heal,
final fingerprints, replay) and the same per-round residuals of the
fault-free twin, the chaos run and its replay (tolerance zero)."""

import numpy as np
import pytest
import torch

import lasp_tpu.chaos as jchaos
from lasp_tpu.mesh import random_regular, ring
from tests.test_torch_chaos import N, _twin

torch.set_num_threads(1)


_HARNESS_TOPOLOGIES = {
    "ring": ring(N, 2),
    "random": random_regular(N, 3, seed=11),
}


def _harness_builder(P, nbrs, built):
    def build():
        store = P.Store(n_actors=8)
        g = store.declare(id="g", type="lasp_gset", n_elems=16)
        s = store.declare(id="s", type="riak_dt_orswot", n_elems=8,
                          n_actors=8)
        rt = P.RT(store, P.Graph(store), N, nbrs)
        rng = np.random.RandomState(3)
        rows = rng.choice(N, 5, replace=False)
        rt.update_batch(
            g, [(int(r), ("add", f"e{int(r) % 6}"), f"c{r}") for r in rows]
        )
        rt.update_at(int(rows[0]), s, ("add", "kept"), "w0")
        rt.update_at(int(rows[1]), s, ("add", "gone"), "w1")
        rt.update_at(int(rows[1]), s, ("remove", "gone"), "w1")
        built.append(rt)
        return rt

    return build


@pytest.mark.parametrize("mode", ["dense", "frontier"])
@pytest.mark.parametrize("preset", sorted(jchaos.PRESETS))
def test_run_harness_preset_matrix_equal_jax(preset, mode):
    """``run_harness`` (twin, chaos run with inflation checks, replay) gives
    JAX's report — rounds, rounds to heal, the final fingerprint — on both
    topologies, and the chaos run's per-round residuals equal JAX's."""
    def scenario(P, obs):
        for topo in sorted(_HARNESS_TOPOLOGIES):
            nbrs = _HARNESS_TOPOLOGIES[topo]
            schedule = P.chaos.nemesis(preset, N, nbrs, seed=9, rounds=8)
            built: list = []
            obs.append(P.inv.run_harness(
                _harness_builder(P, nbrs, built), schedule, mode=mode,
                replay=True, removed_terms={"s": {"gone"}}))
            # built: the fault-free twin, the chaos run, its replay
            obs.append([P.residuals(rt) for rt in built])

    _twin(scenario)
