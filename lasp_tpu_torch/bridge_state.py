"""State exchange with the JAX package, through numpy.

``lasp_tpu`` keeps a codec state as a NamedTuple of arrays (its state
pytree); this port keeps the same fields as torch tensors. The word planes
of the packed and flat OR-Sets are ``uint32`` there and ``int32`` holding
the same bits here. :func:`from_numpy` and :func:`to_numpy` convert
between the two, leaf by leaf, so both packages can start from one seeded
population and be compared bit for bit. A map state (``MapState``) nests:
its ``fields`` are a tuple of embedded states (maps again when nested),
``epochs`` is None outside reset mode, and ``tombs`` is a tuple with None
for every field that carries no tombstone; both directions keep that
structure.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .lattice import (
    CrdtMap,
    GCounter,
    GCounterState,
    GSet,
    GSetState,
    IVar,
    IVarState,
    MapState,
    ORSet,
    ORSetState,
    ORSWOT,
    ORSWOTState,
)
from .ops.flatpack import FlatORSet, FlatORSetState
from .ops.packed import PackedORSet, PackedORSetState

#: codec name -> (codec, state NamedTuple)
CODECS = {
    "lasp_gset": (GSet, GSetState),
    "riak_dt_gcounter": (GCounter, GCounterState),
    "riak_dt_orswot": (ORSWOT, ORSWOTState),
    "lasp_ivar": (IVar, IVarState),
    "lasp_orset": (ORSet, ORSetState),
    "lasp_orset_gbtree": (ORSet, ORSetState),
    "lasp_orset_packed": (PackedORSet, PackedORSetState),
    "lasp_orset_flat": (FlatORSet, FlatORSetState),
    "riak_dt_map": (CrdtMap, MapState),
}

_WORD_STATES = (PackedORSetState, FlatORSetState)


def from_numpy(codec_name: str, spec, leaves, device=None):
    """numpy leaves (the JAX state's fields, in order, with any leading
    replica or group dims) -> the port's state on ``device``. For a map,
    ``leaves`` is the JAX ``MapState`` (or a tuple of its five fields)."""
    if codec_name == "riak_dt_map":
        return _map_from_numpy(spec, leaves, resolve_device(device))
    codec, state_cls = CODECS[codec_name]
    leaves = [np.asarray(x) for x in leaves]
    bottom = codec.new(spec, device="cpu")
    if len(leaves) != len(bottom):
        raise ValueError(
            f"{codec_name}: expected {len(bottom)} leaves, got {len(leaves)}"
        )
    dev = resolve_device(device)
    out = []
    for name, leaf, ref in zip(state_cls._fields, leaves, bottom):
        trailing = leaf.shape[leaf.ndim - ref.dim():] if ref.dim() else ()
        if tuple(trailing) != tuple(ref.shape):
            raise ValueError(
                f"{codec_name}.{name}: trailing shape {leaf.shape} does not "
                f"match the spec's {tuple(ref.shape)}"
            )
        if leaf.dtype == np.uint32:
            leaf = leaf.view(np.int32)
        out.append(torch.tensor(leaf, device=dev))  # a copy: numpy views may be read-only
    return state_cls(*out)


def _tensor(leaf, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(leaf), device=dev)


def _map_from_numpy(spec, leaves, dev) -> MapState:
    clock, dots, fields, epochs, tombs = tuple(leaves)
    if len(fields) != spec.n_fields:
        raise ValueError(
            f"riak_dt_map: {len(fields)} embedded states for a spec of "
            f"{spec.n_fields} fields"
        )
    return MapState(
        clock=_tensor(clock, dev),
        dots=_tensor(dots, dev),
        fields=tuple(
            from_numpy(codec.name, espec, fs, device=dev)
            for (_k, codec, espec), fs in zip(spec.fields, fields)
        ),
        epochs=None if epochs is None else _tensor(epochs, dev),
        tombs=(
            None if tombs is None
            else tuple(None if t is None else _tensor(t, dev) for t in tombs)
        ),
    )


def to_numpy(state) -> tuple:
    """The port's state -> numpy leaves in the JAX package's dtypes (word
    planes as ``uint32``); a map keeps the nesting of its fields, with
    None where JAX holds None."""
    if isinstance(state, MapState):
        return MapState(
            clock=state.clock.detach().cpu().numpy(),
            dots=state.dots.detach().cpu().numpy(),
            fields=tuple(to_numpy(fs) for fs in state.fields),
            epochs=(
                None if state.epochs is None
                else state.epochs.detach().cpu().numpy()
            ),
            tombs=(
                None if state.tombs is None
                else tuple(
                    None if t is None else t.detach().cpu().numpy()
                    for t in state.tombs
                )
            ),
        )
    words = isinstance(state, _WORD_STATES)
    return tuple(
        x.detach().cpu().numpy().view(np.uint32) if words
        else x.detach().cpu().numpy()
        for x in state
    )
