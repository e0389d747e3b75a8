"""Bit-packed OR-Set: token flags as 32-bit words (port of
``lasp_tpu.ops.packed``).

The JAX codec holds ``uint32[E, ceil(T/32)]`` words. PyTorch's ``uint32``
lacks ``maximum``, shifts and ``index_copy_`` on the CPU, so the port
stores the same bits as ``int32`` and reads them as ``uint32`` where
arithmetic needs it (``.view(np.uint32)`` on the host, ``uint32_t`` in the
CUDA kernels). Every join here is bitwise, so it is bit-identical under the
reinterpretation.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..lattice.base import all_trailing
from ..lattice.orset import ORSetSpec, ORSetState
from ..telemetry.spans import ranged

WORD_MASK = 0xFFFFFFFF


def to_int32(words64: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> the int32 with the same bits."""
    return ((words64 + 2**31) % 2**32 - 2**31).to(torch.int32)


def as_uint(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 holding their unsigned value."""
    return words.to(torch.int64) & WORD_MASK


def _byte_bits(device) -> torch.Tensor:
    """uint8[8]: the weight of each bit of a byte, low bit first."""
    return torch.ones(8, dtype=torch.uint8, device=device) << torch.arange(
        8, dtype=torch.uint8, device=device
    )


def pack_bits(flat: torch.Tensor, n_words: int) -> torch.Tensor:
    """bool[..., N] -> int32[..., n_words], bit ``i`` at word ``i // 32``,
    position ``i % 32`` (the JAX packing order). Built a byte at a time
    (two bytes of scratch a bit) and read as little-endian words."""
    with ranged("packed.pack"):
        lead = tuple(flat.shape[:-1])
        padded = torch.zeros(lead + (n_words * 32,), dtype=torch.uint8,
                             device=flat.device)
        padded[..., : flat.shape[-1]] = flat
        weighted = padded.reshape(lead + (n_words * 4, 8)) * _byte_bits(flat.device)
        return weighted.sum(dim=-1, dtype=torch.uint8).view(torch.int32)


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """int32[..., W] -> bool[..., n_bits] (inverse of :func:`pack_bits`),
    read a byte at a time from the little-endian words (one byte of
    scratch a bit)."""
    with ranged("packed.unpack"):
        lead = tuple(words.shape[:-1])
        octets = words.contiguous().view(torch.uint8)
        bits = (octets.unsqueeze(-1) & _byte_bits(words.device)) != 0
        return bits.reshape(lead + (words.shape[-1] * 32,))[..., :n_bits]


@dataclasses.dataclass(frozen=True)
class PackedORSetSpec:
    n_elems: int
    n_actors: int
    tokens_per_actor: int = 4
    token_space: int | None = None

    @property
    def n_tokens(self) -> int:
        if self.token_space is not None:
            return self.token_space
        return self.n_actors * self.tokens_per_actor

    @property
    def n_words(self) -> int:
        return (self.n_tokens + 31) // 32

    def dense(self) -> ORSetSpec:
        return ORSetSpec(
            n_elems=self.n_elems,
            n_actors=self.n_actors,
            tokens_per_actor=self.tokens_per_actor,
            token_space=self.token_space,
        )


class PackedORSetState(NamedTuple):
    exists: torch.Tensor  # int32[..., E, W], read as uint32
    removed: torch.Tensor  # int32[..., E, W]


def _flat_rows(state: PackedORSetState, *idx):
    """Flatten the batch dims to ``B`` and broadcast per-row indices to
    ``[B]``: the written-out ``vmap`` of the per-replica update ops."""
    exists, removed = state
    e_, w_ = exists.shape[-2:]
    batch = exists.shape[:-2]
    dev = exists.device
    flat = [
        torch.as_tensor(i, dtype=torch.int64, device=dev).expand(batch).reshape(-1)
        for i in idx
    ]
    b = torch.arange(flat[0].shape[0], device=dev)
    return (
        exists.reshape(-1, e_, w_).clone(),
        removed.reshape(-1, e_, w_).clone(),
        b,
        flat,
    )


class PackedORSet:
    name = "lasp_orset_packed"
    leafwise_join = "or"

    @staticmethod
    def new(spec: PackedORSetSpec, device=None) -> PackedORSetState:
        dev = resolve_device(device)
        shape = (spec.n_elems, spec.n_words)
        return PackedORSetState(
            exists=torch.zeros(shape, dtype=torch.int32, device=dev),
            removed=torch.zeros(shape, dtype=torch.int32, device=dev),
        )

    # -- updates (batch-polymorphic: one index per leading row) --------------
    @staticmethod
    def add_by_token(spec, state, elem_idx, token_idx) -> PackedORSetState:
        ex, rm, b, (e, t) = _flat_rows(state, elem_idx, token_idx)
        w = t // 32
        bit = to_int32(torch.ones_like(t) << (t % 32))
        ex[b, e, w] = ex[b, e, w] | bit
        rm[b, e, w] = rm[b, e, w] & ~bit
        return PackedORSetState(
            exists=ex.reshape(state.exists.shape),
            removed=rm.reshape(state.removed.shape),
        )

    @staticmethod
    def add_exhausted(spec, state, elem_idx, actor_idx) -> torch.Tensor:
        """The actor's pool for the element is full (dense
        ``ORSet.add_exhausted`` contract), for one state."""
        k = spec.tokens_per_actor
        offs = int(actor_idx) * k + torch.arange(k, device=state.exists.device)
        words = as_uint(state.exists[elem_idx, offs // 32])
        return torch.all(((words >> (offs % 32)) & 1) != 0)

    @staticmethod
    def add(spec, state, elem_idx, actor_idx) -> PackedORSetState:
        """Mint the actor's first free slot (dense ``ORSet.add`` contract:
        pool-exhausted adds are a no-op)."""
        k = spec.tokens_per_actor
        ex, rm, b, (e, a) = _flat_rows(state, elem_idx, actor_idx)
        offs = a[:, None] * k + torch.arange(k, device=a.device)  # [B, k]
        words = as_uint(ex[b, e].gather(1, offs // 32))
        taken = ((words >> (offs % 32)) & 1) != 0
        free = torch.argmax((~taken).to(torch.int32), dim=1)  # first free
        in_range = ~taken.gather(1, free[:, None])[:, 0]
        slot = a * k + free
        sw = slot // 32
        sbit = to_int32(
            torch.where(in_range, torch.ones_like(slot) << (slot % 32), 0)
        )
        ex[b, e, sw] = ex[b, e, sw] | sbit
        rm[b, e, sw] = rm[b, e, sw] & ~sbit
        return PackedORSetState(
            exists=ex.reshape(state.exists.shape),
            removed=rm.reshape(state.removed.shape),
        )

    @staticmethod
    def remove(spec, state, elem_idx) -> PackedORSetState:
        ex, rm, b, (e,) = _flat_rows(state, elem_idx)
        rm[b, e] = rm[b, e] | ex[b, e]
        return PackedORSetState(
            exists=state.exists, removed=rm.reshape(state.removed.shape)
        )

    @staticmethod
    def apply_masks(spec, state, add_tokens, remove_elems) -> PackedORSetState:
        exists = state.exists | add_tokens
        removed = state.removed | torch.where(
            remove_elems[..., None], exists, torch.zeros_like(exists)
        )
        return PackedORSetState(exists=exists, removed=removed)

    # -- lattice ------------------------------------------------------------
    @staticmethod
    def merge(spec, a, b) -> PackedORSetState:
        return PackedORSetState(
            exists=a.exists | b.exists, removed=a.removed | b.removed
        )

    @staticmethod
    def value(spec, state) -> torch.Tensor:
        """bool[..., E]: any live token (exists bit without removed bit)."""
        return torch.any((state.exists & ~state.removed) != 0, dim=-1)

    @staticmethod
    def member_mask(spec, state) -> torch.Tensor:
        return torch.any(state.exists != 0, dim=-1)

    @staticmethod
    def equal(spec, a, b) -> torch.Tensor:
        return all_trailing(a.exists == b.exists, 2) & all_trailing(
            (a.removed & a.exists) == (b.removed & b.exists), 2
        )

    @staticmethod
    def is_inflation(spec, prev, cur) -> torch.Tensor:
        return all_trailing((prev.exists & ~cur.exists) == 0, 2)

    @staticmethod
    def is_strict_inflation(spec, prev, cur) -> torch.Tensor:
        inflation = all_trailing((prev.exists & ~cur.exists) == 0, 2)
        changed = ~all_trailing(
            (prev.exists == cur.exists)
            & ((prev.removed & prev.exists) == (cur.removed & cur.exists)),
            2,
        )
        return inflation & changed


def pack_orset(spec: PackedORSetSpec, dense: ORSetState) -> PackedORSetState:
    """bool[..., E, T] planes -> int32[..., E, W] words (lossless)."""
    return PackedORSetState(
        exists=pack_bits(dense.exists, spec.n_words),
        removed=pack_bits(dense.removed & dense.exists, spec.n_words),
    )


def unpack_orset(spec: PackedORSetSpec, packed: PackedORSetState) -> ORSetState:
    t = spec.n_tokens
    return ORSetState(
        exists=unpack_bits(packed.exists, t), removed=unpack_bits(packed.removed, t)
    )
