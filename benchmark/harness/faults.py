"""Faults planted in the timed path, for the tests and the control that
show the check fails: each takes a driver (its population built, before
the set-up's warm-up) and breaks the program underneath it.

- ``unchanged_step``: every gossip round returns the state unchanged and
  reports nothing changed;
- ``half_batch``: half of the work left out: each cycle's ops after the
  first half of every variable's list, or, where the window writes
  nothing, the second half of the replicas left out of the exchange
  (each pulls from itself);
- ``altered_answer``: one element of one variable's converged state
  altered where the round produced it;
- ``early_answer`` (the control): a store that reports its writes
  visible before quiescence, convergence stopped at half its rounds.
"""

from __future__ import annotations

import torch

from .state import tree_map, leaves, restore, snapshot


def _rows_fault(rt):
    """Wrap the dense round and the frontier round so that nothing
    changes and each reports so."""

    def guarded(inner, returns_tensor):
        def run(*args, **kwargs):
            before = {v: [x.clone() for x in leaves(st)]
                      for v, st in rt.states.items()}
            out = inner(*args, **kwargs)
            for v, ls in before.items():
                rt.states[v] = _rebuild(rt.states[v], ls)
            return torch.zeros_like(out) if returns_tensor else 0
        return run

    rt._dense_round = guarded(rt._dense_round, True)
    rt.frontier_step = guarded(rt.frontier_step, False)


def _rebuild(state, old_leaves):
    it = iter(old_leaves)
    return tree_map(lambda _x: next(it), state)


def unchanged_step(driver) -> None:
    _rows_fault(driver.pop.rt)


def half_batch(driver) -> None:
    rt = driver.pop.rt
    if driver.mix["driver"] == "replay":
        half, n = rt.n_replicas // 2, rt.n_replicas
        own = torch.arange(half, n, device=rt.neighbors.device)
        rt.neighbors[half:] = own[:, None].to(rt.neighbors.dtype)
        return
    inner = rt.ingest_cycle

    def halved(cycle, *args, **kwargs):
        return inner({v: ops[: (len(ops) + 1) // 2] for v, ops in cycle.items()},
                     *args, **kwargs)

    rt.ingest_cycle = halved


def altered_answer(driver) -> None:
    rt = driver.pop.rt
    inner = driver._converge
    target = driver.pop.var_ids[-1]

    def altered():
        out = inner()
        leaf = leaves(rt.states[target])[0]
        row = leaf[rt.n_replicas // 3].view(-1)
        if row.dtype == torch.bool:
            row[0] = ~row[0]
        else:
            row[0] += 1
        return out

    driver._converge = altered


def early_answer(driver) -> None:
    rt = driver.pop.rt
    how = driver.mix["converge"]

    def early():
        # the rounds the population needs, then half of them, as if the
        # store answered at that point
        snap = snapshot(rt)
        if how == "on_device":
            full = rt.converge_on_device()
        else:
            full = rt.run_to_convergence(mode=how)
        restore(rt, snap)
        if how == "auto":
            # the frontier marks went with the rounds: start dense again
            rt.mark_dirty()
        if how == "on_device":
            return rt.converge_on_device(max_rounds=max(full // 2, 1), strict=False)
        n = 0
        for _ in range(max(full // 2, 1)):
            n += 1
            if rt.frontier_step() == 0:
                break
        return n

    driver._converge = early


FAULTS = {"unchanged_step": unchanged_step, "half_batch": half_batch,
          "altered_answer": altered_answer, "early_answer": early_answer}
