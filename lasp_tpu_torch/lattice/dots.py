"""Shared dot-matrix algebra for the vclock-based types (port of
``lasp_tpu.lattice.dots``; reference ``src/lasp_lattice.erl:163-167,
255-271``, which applies one rule to ``riak_dt_orswot`` and ``riak_dt_map``).

Batch-polymorphic like the rest of the port: ``clock`` is ``int32[..., A]``
and ``dots`` ``int32[..., E, A]`` with any leading replica or group dims.
"""

from __future__ import annotations

import torch


def merge_dots(clock_a, dots_a, clock_b, dots_b):
    """Join two (clock, dots) pairs. A dot survives iff present on both
    sides, or present on one side and unseen by the other's clock (a newer
    add that side has not learned; a seen-but-absent dot was removed).
    Returns (clock, dots), with the JAX rule's op order."""
    clock = torch.maximum(clock_a, clock_b)
    keep_a = (dots_a > 0) & ((dots_a == dots_b) | (dots_a > clock_b[..., None, :]))
    keep_b = (dots_b > 0) & ((dots_b == dots_a) | (dots_b > clock_a[..., None, :]))
    zero = torch.zeros_like(dots_a)
    dots = torch.maximum(
        torch.where(keep_a, dots_a, zero), torch.where(keep_b, dots_b, zero)
    )
    return clock, dots


def clock_inflation(prev_clock, cur_clock) -> torch.Tensor:
    """vclock descends (``src/lasp_lattice.erl:163-167``)."""
    return torch.all(prev_clock <= cur_clock, dim=-1)


def strict_clock_inflation(prev_clock, prev_dots, cur_clock, cur_dots) -> torch.Tensor:
    """``src/lasp_lattice.erl:255-271``: inflation and (equal clocks with
    fewer present entries — a removal — or a strictly dominating clock)."""
    inflation = clock_inflation(prev_clock, cur_clock)
    equal_clocks = torch.all(prev_clock == cur_clock, dim=-1)
    dominates = inflation & torch.any(cur_clock > prev_clock, dim=-1)
    deleted = torch.sum(torch.any(cur_dots > 0, dim=-1), dim=-1) < torch.sum(
        torch.any(prev_dots > 0, dim=-1), dim=-1
    )
    return inflation & ((equal_clocks & deleted) | dominates)


def mint_dot(clock, dots, entry_idx, actor_idx):
    """Advance the actor's clock and replace the entry's dots with the fresh
    single dot (the shared ``add`` move), on one state. Returns new
    (clock, dots); the inputs are not modified."""
    clock = clock.clone()
    clock[..., actor_idx] += 1
    row = torch.zeros_like(clock)
    row[..., actor_idx] = clock[..., actor_idx]
    dots = dots.clone()
    dots[..., entry_idx, :] = row
    return clock, dots
