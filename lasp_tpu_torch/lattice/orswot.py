"""OR-SWOT: observe-remove set without tombstones, as (vclock, dot-matrix)
(port of ``lasp_tpu.lattice.orswot``; reference ``riak_dt_orswot``).

``clock: int32[A]`` (the per-actor max event) and ``dots: int32[E, A]``
(0 = no dot, else the event counter of the add). ``add`` advances the
actor's clock and replaces the element's dots with the fresh single dot;
``remove`` drops the entry (the clock remembers it); ``merge`` is
:func:`.dots.merge_dots`. ``is_inflation`` = clock descends,
``is_strict_inflation`` as ``src/lasp_lattice.erl:255-262``.

The leaves are ``int32``, whose ``maximum``, ``>`` and ``==`` PyTorch's CPU
build supports, so OR-SWOT needs no word view.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..device import resolve_device
from .base import CrdtType, all_trailing
from .dots import clock_inflation, merge_dots, mint_dot, strict_clock_inflation


@dataclasses.dataclass(frozen=True)
class ORSWOTSpec:
    n_elems: int
    n_actors: int


class ORSWOTState(NamedTuple):
    clock: torch.Tensor  # int32[..., A] — per-actor max event counter
    dots: torch.Tensor  # int32[..., E, A] — birth dot of each live element, 0 = none


class ORSWOT(CrdtType):
    name = "riak_dt_orswot"

    @staticmethod
    def new(spec: ORSWOTSpec, device=None) -> ORSWOTState:
        dev = resolve_device(device)
        return ORSWOTState(
            clock=torch.zeros((spec.n_actors,), dtype=torch.int32, device=dev),
            dots=torch.zeros((spec.n_elems, spec.n_actors), dtype=torch.int32,
                             device=dev),
        )

    # -- updates (one state, host-side indices) ------------------------------
    @staticmethod
    def add(spec: ORSWOTSpec, state: ORSWOTState, elem_idx, actor_idx) -> ORSWOTState:
        """``update({add, E}, Actor)``: bump the actor's clock, replace the
        element's dots with the fresh single dot."""
        return ORSWOTState(*mint_dot(state.clock, state.dots, elem_idx, actor_idx))

    @staticmethod
    def remove(spec: ORSWOTSpec, state: ORSWOTState, elem_idx) -> ORSWOTState:
        """``update({remove, E})``: drop the entry; the clock already
        witnesses its dots, so merges cannot resurrect it."""
        dots = state.dots.clone()
        dots[..., elem_idx, :] = 0
        return ORSWOTState(clock=state.clock, dots=dots)

    # -- lattice ------------------------------------------------------------
    @staticmethod
    def merge(spec: ORSWOTSpec, a: ORSWOTState, b: ORSWOTState) -> ORSWOTState:
        return ORSWOTState(*merge_dots(a.clock, a.dots, b.clock, b.dots))

    @staticmethod
    def value(spec: ORSWOTSpec, state: ORSWOTState) -> torch.Tensor:
        """bool[..., E]: the element holds at least one live dot."""
        return torch.any(state.dots > 0, dim=-1)

    member_mask = value

    @staticmethod
    def equal(spec: ORSWOTSpec, a: ORSWOTState, b: ORSWOTState) -> torch.Tensor:
        return all_trailing(a.clock == b.clock, 1) & all_trailing(a.dots == b.dots, 2)

    @staticmethod
    def is_inflation(spec: ORSWOTSpec, prev: ORSWOTState, cur: ORSWOTState) -> torch.Tensor:
        return clock_inflation(prev.clock, cur.clock)

    @staticmethod
    def is_strict_inflation(
        spec: ORSWOTSpec, prev: ORSWOTState, cur: ORSWOTState
    ) -> torch.Tensor:
        return strict_clock_inflation(prev.clock, prev.dots, cur.clock, cur.dots)

    @staticmethod
    def stats(spec: ORSWOTSpec, state: ORSWOTState) -> dict:
        return {
            "element_count": int(torch.sum(torch.any(state.dots > 0, dim=-1))),
            "clock_total": int(torch.sum(state.clock)),
        }
