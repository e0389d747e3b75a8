"""Flat bit-packed OR-Set: the mesh wire format, 1 bit per (elem, token)
(port of ``lasp_tpu.ops.flatpack``).

The whole (elem, token) grid flattens to one bit axis (``bit = e * T + t``)
packed into 32-bit words — the representation
``ReplicatedRuntime(packed=True)`` holds OR-Set populations in. Words are
stored as ``int32`` holding the ``uint32`` bits (see ``ops.packed``). Only
merge / equal / inflation run natively on words; decodes delegate to the
dense codec through ``unpack``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..lattice.base import all_trailing
from ..lattice.orset import ORSet, ORSetSpec, ORSetState
from .packed import pack_bits, to_int32, unpack_bits


@dataclasses.dataclass(frozen=True)
class FlatORSetSpec:
    dense: ORSetSpec

    @property
    def n_bits(self) -> int:
        return self.dense.n_elems * self.dense.n_tokens

    @property
    def n_words(self) -> int:
        return (self.n_bits + 31) // 32


class FlatORSetState(NamedTuple):
    exists: torch.Tensor  # int32[..., W], read as uint32
    removed: torch.Tensor  # int32[..., W]


def _pack(spec: FlatORSetSpec, plane: torch.Tensor) -> torch.Tensor:
    """bool[..., E, T] -> int32[..., W]."""
    flat = plane.reshape(plane.shape[:-2] + (spec.n_bits,))
    return pack_bits(flat, spec.n_words)


def _unpack(spec: FlatORSetSpec, words: torch.Tensor) -> torch.Tensor:
    """int32[..., W] -> bool[..., E, T]."""
    d = spec.dense
    return unpack_bits(words, spec.n_bits).reshape(
        words.shape[:-1] + (d.n_elems, d.n_tokens)
    )


class FlatORSet:
    name = "lasp_orset_flat"
    leafwise_join = "or"

    @staticmethod
    def new(spec: FlatORSetSpec, device=None) -> FlatORSetState:
        dev = resolve_device(device)
        return FlatORSetState(
            exists=torch.zeros((spec.n_words,), dtype=torch.int32, device=dev),
            removed=torch.zeros((spec.n_words,), dtype=torch.int32, device=dev),
        )

    # -- conversions ---------------------------------------------------------
    @staticmethod
    def pack(spec: FlatORSetSpec, dense: ORSetState) -> FlatORSetState:
        return FlatORSetState(
            exists=_pack(spec, dense.exists),
            # canonicalize: tombstone bits only meaningful where minted
            removed=_pack(spec, dense.removed & dense.exists),
        )

    @staticmethod
    def unpack(spec: FlatORSetSpec, state: FlatORSetState) -> ORSetState:
        return ORSetState(
            exists=_unpack(spec, state.exists), removed=_unpack(spec, state.removed)
        )

    # -- hot operations (native on words) ------------------------------------
    @staticmethod
    def merge(spec, a: FlatORSetState, b: FlatORSetState) -> FlatORSetState:
        return FlatORSetState(exists=a.exists | b.exists, removed=a.removed | b.removed)

    @staticmethod
    def equal(spec, a: FlatORSetState, b: FlatORSetState) -> torch.Tensor:
        return all_trailing(a.exists == b.exists, 1) & all_trailing(
            (a.removed & a.exists) == (b.removed & b.exists), 1
        )

    @staticmethod
    def is_inflation(spec, prev, cur) -> torch.Tensor:
        return all_trailing((prev.exists & ~cur.exists) == 0, 1)

    @staticmethod
    def is_strict_inflation(spec, prev, cur) -> torch.Tensor:
        return ORSet.is_strict_inflation(
            spec.dense, FlatORSet.unpack(spec, prev), FlatORSet.unpack(spec, cur)
        )

    # -- decode (delegates through unpack) -----------------------------------
    @staticmethod
    def value(spec, state) -> torch.Tensor:
        return ORSet.value(spec.dense, FlatORSet.unpack(spec, state))

    @staticmethod
    def member_mask(spec, state) -> torch.Tensor:
        return ORSet.member_mask(spec.dense, FlatORSet.unpack(spec, state))

    @staticmethod
    def threshold_met(spec, state, threshold) -> torch.Tensor:
        thr = threshold
        if isinstance(getattr(thr, "state", None), FlatORSetState):
            thr = thr._replace(state=FlatORSet.unpack(spec, thr.state))
        return ORSet.threshold_met(spec.dense, FlatORSet.unpack(spec, state), thr)

    @staticmethod
    def stats(spec, state) -> dict:
        return ORSet.stats(spec.dense, FlatORSet.unpack(spec, state))

    # -- vectorized seeding ----------------------------------------------------
    @staticmethod
    def scatter_tokens(
        spec: FlatORSetSpec, states: FlatORSetState, rows, elems, tokens
    ) -> FlatORSetState:
        """OR token bits into a replicated ``[R, W]`` state at ``(rows[i],
        elems[i], tokens[i])``. The triples MUST be unique: with unique
        bits an add-scatter into a zero buffer never carries, so it equals
        a scatter-OR (int32 wrap-around included).

        The index arithmetic is JAX's: the bit index is
        ``uint32(elem) * n_tokens + uint32(token)`` in uint32 (emulated in
        int64), a word outside ``[0, W)`` drops, negative rows wrap and
        out-of-range rows drop. A token past its element's range but inside
        the row aliases into the next element, as in JAX. The dropped
        triples are filtered out before the scatter, so the card only sees
        valid indices."""
        d = spec.dense
        dev = states.exists.device
        r_cap, w_cap = states.exists.shape
        rows = torch.as_tensor(rows, dtype=torch.int64, device=dev).reshape(-1)
        u32 = 0xFFFFFFFF
        bit = (
            (torch.as_tensor(elems, dtype=torch.int64, device=dev).reshape(-1) & u32)
            * d.n_tokens
            + (torch.as_tensor(tokens, dtype=torch.int64, device=dev).reshape(-1) & u32)
        ) & u32
        word = bit // 32
        rows = torch.where(rows < 0, rows + r_cap, rows)
        keep = (rows >= 0) & (rows < r_cap) & (word < w_cap)
        rows, word, bit = rows[keep], word[keep], bit[keep]
        mask = to_int32(torch.ones_like(bit) << (bit % 32))
        add_words = torch.zeros_like(states.exists)
        add_words.index_put_((rows, word), mask, accumulate=True)
        return states._replace(
            exists=states.exists | add_words,
            removed=states.removed & ~add_words,
        )
