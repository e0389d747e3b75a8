"""State exchange with the JAX package, through numpy.

``lasp_tpu`` keeps a codec state as a NamedTuple of arrays (its state
pytree); this port keeps the same fields as torch tensors. The word planes
of the packed and flat OR-Sets are ``uint32`` there and ``int32`` holding
the same bits here. :func:`from_numpy` and :func:`to_numpy` convert
between the two, leaf by leaf, so both packages can start from one seeded
population and be compared bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .lattice import (
    GCounter,
    GCounterState,
    GSet,
    GSetState,
    IVar,
    IVarState,
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
}

_WORD_STATES = (PackedORSetState, FlatORSetState)


def from_numpy(codec_name: str, spec, leaves, device=None):
    """numpy leaves (the JAX state's fields, in order, with any leading
    replica or group dims) -> the port's state on ``device``."""
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


def to_numpy(state) -> tuple:
    """The port's state -> numpy leaves in the JAX package's dtypes
    (word planes as ``uint32``)."""
    words = isinstance(state, _WORD_STATES)
    return tuple(
        x.detach().cpu().numpy().view(np.uint32) if words
        else x.detach().cpu().numpy()
        for x in state
    )
