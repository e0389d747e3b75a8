"""Cross-variable dispatch plan: the gossip plan compiler (port of
``lasp_tpu.mesh.plan``).

A store of many small named CRDTs is the common shape of a deployment, and
one kernel launch per variable per round makes the launch floor dominate
long before the work does. The plan groups the runtime's variables by the
signature the mesh sees —

    (mesh codec class, mesh spec)

— (flat-packed OR-Sets group by their ``FlatORSetSpec``). Members of a
group have identical leaf shapes and dtypes, so one row-sparse kernel
launch serves every active member of a group per round
(``ReplicatedRuntime._frontier_round_planned``).

Grouping and order are exactly the JAX package's: groups in first-appearance
order of their signature, members in ``var_ids`` order, and a variable whose
spec does not hash rides alone as a singleton group after the others. The
plan is host bookkeeping only; the runtime owns compilation and
invalidation. Each compilation counts ``plan_compile_total`` and sets the
``gossip_plan_groups`` / ``gossip_plan_vars_per_dispatch`` gauges, as JAX's.

:func:`stack_group` / :func:`unstack_group` are the ``[G, R, ...]`` stacking
helpers of the JAX plan. The port's runtime does not stack member
populations on its hot path — a stack copies every member each round; the
kernels read the members where they lie (``ops.cuda_gossip``) — so they
serve the plain reference paths and the tests.
"""

from __future__ import annotations

import dataclasses

import torch

from ..lattice.base import tree_map
from ..telemetry import counter, gauge


@dataclasses.dataclass(frozen=True)
class PlanGroup:
    """One same-signature variable group of a :class:`DispatchPlan`;
    ``var_ids`` in the runtime's ``var_ids`` order, ``codec`` / ``spec`` the
    mesh-side pair every member shares."""

    var_ids: tuple
    codec: type
    spec: object

    def __len__(self) -> int:
        return len(self.var_ids)


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """An immutable grouping of a runtime's variables, recompiled (on the
    host, cheaply) whenever the runtime invalidates it."""

    groups: tuple
    n_replicas: int

    @property
    def n_vars(self) -> int:
        return sum(len(g) for g in self.groups)

    def describe(self) -> dict:
        """Host-readable summary, the same dict as the JAX plan's."""
        return {
            "groups": len(self.groups),
            "vars": self.n_vars,
            "vars_per_group": [len(g) for g in self.groups],
            "signatures": [
                (g.codec.__name__, repr(g.spec)) for g in self.groups
            ],
        }


def hashable_signature(*parts):
    """The parts as one tuple, or None when any part refuses to hash (such
    a variable degrades to a singleton group rather than failing a plan)."""
    try:
        hash(parts)
    except TypeError:
        return None
    return parts


def signature_of(runtime, var_id: str):
    """The grouping signature of one variable as the mesh sees it, or None
    when its spec is not hashable."""
    codec, spec = runtime._mesh_meta(var_id)
    return hashable_signature(codec, spec)


def compile_plan(runtime) -> DispatchPlan:
    """Group ``runtime.var_ids`` by signature: groups in first-appearance
    order, members in ``var_ids`` order, unhashable singletons last."""
    by_sig: dict = {}
    singletons: list = []
    for v in runtime.var_ids:
        sig = signature_of(runtime, v)
        if sig is None:
            singletons.append(v)
        else:
            by_sig.setdefault(sig, []).append(v)  # dicts keep first appearance
    groups = [
        PlanGroup(var_ids=tuple(vs), codec=sig[0], spec=sig[1])
        for sig, vs in by_sig.items()
    ]
    for v in singletons:
        codec, spec = runtime._mesh_meta(v)
        groups.append(PlanGroup(var_ids=(v,), codec=codec, spec=spec))
    plan = DispatchPlan(groups=tuple(groups), n_replicas=runtime.n_replicas)
    counter(
        "plan_compile_total",
        help="dispatch-plan compilations (grouping walks, host-side)",
    ).inc()
    gauge(
        "gossip_plan_groups",
        help="variable groups in the current dispatch plan (same-codec "
             "variables stack into one kernel per group)",
    ).set(len(plan.groups))
    if plan.groups:
        gauge(
            "gossip_plan_vars_per_dispatch",
            help="mean variables served per stacked dispatch under the "
                 "current plan (refreshed per planned frontier round)",
        ).set(round(plan.n_vars / len(plan.groups), 3))
    return plan


def stack_group(states_seq):
    """Stack per-member ``[R, ...]`` populations into the group's
    ``[G, R, ...]`` tensors (a copy of every member)."""
    states_seq = list(states_seq)
    return tree_map(lambda *leaves: torch.stack(leaves), *states_seq)


def unstack_group(stacked, n: int) -> tuple:
    """Per-member views of ``[G, R, ...]`` tensors, in member order."""
    return tuple(tree_map(lambda x: x[i], stacked) for i in range(n))
