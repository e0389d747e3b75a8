"""Checkpoint / resume: durable snapshots of store and replica state (port of
``lasp_tpu.store.checkpoint``), in the JAX package's file format, so each
package reads the other's checkpoints.

A checkpoint is one :class:`~.host_store.HostStore` log: a pickled manifest
(variable specs, interner contents, counters) plus one raw-bytes record per
state leaf; ``save_runtime`` also keeps every variable's replicated
``[R, ...]`` states and the topology. Dataflow edges and triggers hold
Python callables and are not saved: rebuild them after a load.

What makes the files common to both packages:

- **Class names.** Manifests pickle spec objects, whose classes live in
  ``lasp_tpu.lattice`` / ``lasp_tpu.ops`` there and in
  ``lasp_tpu_torch.lattice`` / ``lasp_tpu_torch.ops`` here under the same
  names. The writer records the JAX package's module names (as strings:
  nothing of it is imported) and the restricted reader maps them back, so
  the JAX reader, which admits only its own names, reads the port's files.
- **Leaves.** Leaves are written in the JAX package's dtypes and in its
  ``tree_leaves`` order (``None`` fields skipped): the port's ``int32``
  views of packed word planes go to disk as ``uint32`` and come back as
  views (``bridge_state.to_numpy``).

The counters record carries the store's ``metrics`` (binds, inflations,
ignored binds, reads) and ``mutations``, as JAX's does.
"""

from __future__ import annotations

import io
import pickle

import numpy as np
import torch

from ..bridge_state import to_numpy
from ..device import resolve_device
from ..lattice.base import tree_leaves, tree_unflatten
from .host_store import HostStore
from .store import Store, Variable

#: this package's pickled class modules <-> the JAX package's
_PORT_PREFIXES = ("lasp_tpu_torch.lattice", "lasp_tpu_torch.ops")
_REF_PREFIXES = ("lasp_tpu.lattice", "lasp_tpu.ops")
_PORT_PKG, _REF_PKG = "lasp_tpu_torch", "lasp_tpu"
#: the pickle protocol of the JAX package's ``pickle.dumps`` on Python 3.12
_PROTOCOL = 4


def _under(module: str, prefixes) -> bool:
    return any(module == p or module.startswith(p + ".") for p in prefixes)


class _ManifestUnpickler(pickle.Unpickler):
    """Restricted unpickler for manifests: a checkpoint file is untrusted
    input, and a stock ``pickle.loads`` runs arbitrary ``__reduce__``
    payloads. Only the spec / codec classes of this package resolve (named
    by either package's module path); every other global is refused before
    anything is built."""

    def find_class(self, module, name):
        if _under(module, _REF_PREFIXES):
            module = _PORT_PKG + module[len(_REF_PKG):]
        if _under(module, _PORT_PREFIXES):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError) as exc:
                raise pickle.UnpicklingError(
                    f"checkpoint manifest names {module}.{name}, which this "
                    f"package does not have: {exc}"
                ) from None
        raise pickle.UnpicklingError(
            f"checkpoint manifest may not reference {module}.{name}"
        )


def loads_manifest(raw: bytes):
    """Deserialize a checkpoint manifest with the restricted unpickler."""
    return _ManifestUnpickler(io.BytesIO(raw)).load()


class _ManifestPickler(pickle._Pickler):
    """The pure-Python pickler, writing this package's lattice / ops classes
    under the JAX package's module names."""

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", None) or ""
        if self.proto < 4 or not _under(module, _PORT_PREFIXES):
            return super().save_global(obj, name)
        self.save(_REF_PKG + module[len(_PORT_PKG):])
        self.save(name or obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def dumps_manifest(obj) -> bytes:
    buf = io.BytesIO()
    _ManifestPickler(buf, protocol=_PROTOCOL).dump(obj)
    return buf.getvalue()


def _leaf_key(var_id: str, i: int) -> str:
    return f"leaf/{var_id}/{i}"


def _varmeta_key(var_id) -> str:
    return f"varmeta/{var_id!r}"


def _var_manifest(var: Variable) -> dict:
    from ..dataflow.engine import PairUniverse

    m = {
        "type_name": var.type_name,
        "spec": var.spec,
        "elems": None,
        "ivar_payloads": None,
        "map_aux": None,
    }
    # a PairUniverse's terms derive from its source interners; only plain
    # interners keep their own term lists
    if (var.elems is not None and hasattr(var.elems, "terms")
            and not isinstance(var.elems, PairUniverse)):
        m["elems"] = list(var.elems.terms())
    if var.ivar_payloads is not None:
        m["ivar_payloads"] = list(var.ivar_payloads.terms())
    if var.map_aux is not None:
        m["map_aux"] = [_shim_manifest(s) for s in var.map_aux]
    if var.actors is not None:
        m["actors"] = list(var.actors.terms())
    return m


def _shim_manifest(shim) -> dict:
    """One map-field shim's interner terms, recursing into nested maps."""
    out = {
        "elems": list(shim.elems.terms()) if shim.elems is not None else None,
        "ivar_payloads": (
            list(shim.ivar_payloads.terms())
            if shim.ivar_payloads is not None else None
        ),
    }
    if shim.map_aux is not None:
        out["map_aux"] = [_shim_manifest(s) for s in shim.map_aux]
    return out


def _restore_interners(var: Variable, m: dict) -> None:
    for key, interner in (("elems", var.elems), ("ivar_payloads", var.ivar_payloads),
                          ("actors", var.actors)):
        for t in m.get(key) or ():
            interner.intern(t)
    if m.get("map_aux") is not None:
        _restore_shims(var.map_aux, m["map_aux"])


def _restore_shims(shims, manifests) -> None:
    for shim, sm in zip(shims, manifests):
        for t in sm["elems"] or ():
            shim.elems.intern(t)
        for t in sm["ivar_payloads"] or ():
            shim.ivar_payloads.intern(t)
        if sm.get("map_aux") is not None and shim.map_aux is not None:
            _restore_shims(shim.map_aux, sm["map_aux"])


def _np_leaves(state) -> list:
    """The state's leaves as numpy arrays in the JAX package's dtypes and
    ``tree_leaves`` order (``None`` skipped)."""
    return [np.asarray(x) for x in tree_leaves(to_numpy(state))]


def _put_state(hs: HostStore, var_id: str, state, entry: dict) -> None:
    leaves = _np_leaves(state)
    entry["leaves"] = [(str(x.dtype), x.shape) for x in leaves]
    for i, x in enumerate(leaves):
        hs.put(_leaf_key(var_id, i), x.tobytes())


def _as_live(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A saved leaf as a tensor shaped and typed like the live leaf: JAX's
    ``uint32`` words come back as the port's ``int32`` view."""
    if a.dtype == np.uint32 and like.dtype == torch.int32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device=like.device, dtype=like.dtype)


def _get_state(hs: HostStore, var_id: str, template, entry: dict):
    live = tree_leaves(template)
    out = []
    for i, (dtype, shape) in enumerate(entry["leaves"]):
        raw = hs.get(_leaf_key(var_id, i))
        if raw is None:
            raise IOError(f"checkpoint missing leaf {var_id}/{i}")
        out.append(np.frombuffer(raw, dtype=dtype).reshape(shape))
    if len(out) < len(live):
        # schema migration, narrowly gated (``lasp_tpu/store/checkpoint.py:
        # 146-195``): a reset-mode map snapshot from before the tombs planes
        # existed stores a strict prefix of today's leaves, and ONLY the
        # tombs suffix may take the template's bottoms. Any other short
        # snapshot is truncated and fails loudly.
        tombs = getattr(template, "tombs", None)
        n_tombs = len(tree_leaves(tombs)) if tombs is not None else 0
        if not (entry.get("type_name") == "riak_dt_map" and n_tombs
                and len(live) - len(out) == n_tombs):
            raise IOError(
                f"checkpoint truncated for {var_id}: snapshot has "
                f"{len(entry['leaves'])} leaves, current layout needs "
                f"{len(live)} (only a reset-mode riak_dt_map may backfill, "
                "and only its tombs planes)"
            )
    if len(out) > len(live):
        raise IOError(
            f"checkpoint leaf count mismatch for {var_id}: snapshot has "
            f"{len(entry['leaves'])}, current layout needs {len(live)}"
        )
    leaves = [_as_live(a, x) for a, x in zip(out, live)] + live[len(out):]
    return tree_unflatten(template, leaves)


def save_store(store: Store, path: str) -> None:
    """Snapshot a single-replica store: a header record listing the
    variable ids, one ``varmeta/<id>`` record per variable (spec,
    interners, leaf shapes), a ``counters`` record and the raw leaf
    records."""
    with HostStore(path) as hs:
        header = {"kind": "store", "n_actors": store.n_actors,
                  "var_ids": list(store.ids())}
        for var_id in store.ids():
            var = store.variable(var_id)
            entry = _var_manifest(var)
            _put_state(hs, var_id, var.state, entry)
            hs.put(_varmeta_key(var_id), dumps_manifest(entry))
        # the counters record's schema is the JAX package's: {"schema": 1,
        # "metrics": {...}, "mutations": int}
        hs.put("counters", dumps_manifest(
            {"schema": 1, "metrics": store.metrics.snapshot(),
             "mutations": store.mutations}))
        hs.put("manifest", dumps_manifest(header))


def load_store(path: str, device=None) -> Store:
    """Rebuild a store from a snapshot (either package's), on ``device``
    (default CUDA)."""
    device = resolve_device(device)
    with HostStore(path) as hs:
        raw = hs.get("manifest")
        if raw is None:
            raise IOError(f"no checkpoint manifest in {path}")
        header = loads_manifest(raw)
        store = Store(n_actors=header["n_actors"], device=device)
        counters = hs.get("counters")
        if counters is not None:
            counters = loads_manifest(counters)
            store.metrics.update(counters.get("metrics", {}))
            store.mutations = counters.get("mutations", 0)
        if header.get("kind") == "runtime":
            raise IOError(
                f"{path} is a runtime checkpoint (replicated [R, ...] "
                "states); use load_runtime, not load_store"
            )
        if "var_ids" in header:
            entries = []
            for var_id in header["var_ids"]:
                raw_entry = hs.get(_varmeta_key(var_id))
                if raw_entry is None:
                    raise IOError(f"checkpoint missing varmeta for {var_id!r}")
                entries.append((var_id, loads_manifest(raw_entry)))
        elif "vars" in header:
            # the older layout: entries and counters inline in the manifest
            entries = list(header["vars"].items())
            store.metrics.update(header.get("metrics", {}))
            store.mutations = header.get("mutations", store.mutations)
        else:
            raise IOError(
                f"unrecognized checkpoint manifest in {path}: has neither "
                "'var_ids' (current) nor 'vars' (legacy inline) — not a "
                "store snapshot?"
            )
        for var_id, entry in entries:
            store.declare(id=var_id, type=entry["type_name"], spec=entry["spec"])
            var = store.variable(var_id)
            _restore_interners(var, entry)
            var.state = _get_state(hs, var_id, var.state, entry)
        return store


def save_runtime(runtime, path: str) -> None:
    """Snapshot a ReplicatedRuntime: per-variable ``[R, ...]`` states plus
    the topology."""
    runtime._refuse_across("save_runtime", 10)
    with HostStore(path) as hs:
        manifest = {
            "kind": "runtime",
            "n_actors": runtime.store.n_actors,
            "n_replicas": runtime.n_replicas,
            "packed": runtime.packed,
            "vars": {},
        }
        for var_id in runtime.var_ids:
            entry = _var_manifest(runtime.store.variable(var_id))
            _put_state(hs, var_id, runtime.states[var_id], entry)
            manifest["vars"][var_id] = entry
        nb = np.ascontiguousarray(runtime._host_neighbors, dtype=np.int32)
        manifest["neighbors"] = (str(nb.dtype), nb.shape)
        hs.put("neighbors", nb.tobytes())
        hs.put("manifest", dumps_manifest(manifest))


def load_runtime_rows(path: str, replica: int) -> dict:
    """ONE replica's row of every variable from a runtime checkpoint,
    without rebuilding the runtime: ``{var_id: [row leaf arrays, ...]}`` in
    the checkpoint's leaf order and dtypes, the form
    ``ReplicatedRuntime.reseed_row`` takes (the crash-recovery restore
    source: ``src/lasp_vnode.erl:220-237``)."""
    with HostStore(path) as hs:
        raw = hs.get("manifest")
        if raw is None:
            raise IOError(f"no checkpoint manifest in {path}")
        manifest = loads_manifest(raw)
        if manifest.get("kind") != "runtime":
            raise IOError(
                f"{path} is not a runtime checkpoint (kind="
                f"{manifest.get('kind')!r}); row restore needs the "
                "replicated [R, ...] states"
            )
        n_replicas = manifest["n_replicas"]
        if not 0 <= replica < n_replicas:
            raise IndexError(
                f"replica {replica} out of range for the snapshot's "
                f"{n_replicas} replicas"
            )
        out: dict = {}
        for var_id, entry in manifest["vars"].items():
            leaves = []
            for i, (dtype, shape) in enumerate(entry["leaves"]):
                raw_leaf = hs.get(_leaf_key(var_id, i))
                if raw_leaf is None:
                    raise IOError(f"checkpoint missing leaf {var_id}/{i}")
                full = np.frombuffer(raw_leaf, dtype=dtype).reshape(shape)
                leaves.append(np.array(full[replica]))
            out[var_id] = leaves
        return out


def load_runtime(path: str, graph=None, n_replicas=None, neighbors=None,
                 device=None):
    """Rebuild a ReplicatedRuntime (store, replica states, topology) on
    ``device`` (default CUDA). Dataflow edges are code, not data: pass
    ``graph=lambda store: build_graph(store)`` to rebuild them against the
    returned runtime's store.

    Elastic restore: ``n_replicas`` with a matching ``neighbors`` topology
    restores onto another population size (the runtime is rebuilt at the
    snapshot's size, then ``resize`` grows or gracefully shrinks it);
    ``neighbors`` alone swaps the topology through ``resize``'s checks."""
    from ..dataflow.engine import Graph
    from ..mesh.runtime import ReplicatedRuntime

    device = resolve_device(device)
    with HostStore(path) as hs:
        raw = hs.get("manifest")
        if raw is None:
            raise IOError(f"no checkpoint manifest in {path}")
        manifest = loads_manifest(raw)
        if manifest.get("kind") != "runtime":
            raise IOError(f"{path} is not a runtime checkpoint")
        store = Store(n_actors=manifest["n_actors"], device=device)
        for var_id, entry in manifest["vars"].items():
            store.declare(id=var_id, type=entry["type_name"], spec=entry["spec"])
            _restore_interners(store.variable(var_id), entry)
        g = graph(store) if callable(graph) else Graph(store)
        dtype, shape = manifest["neighbors"]
        saved_neighbors = np.frombuffer(hs.get("neighbors"), dtype=dtype).reshape(shape)
        rt = ReplicatedRuntime(
            store, g, manifest["n_replicas"], saved_neighbors,
            packed=manifest.get("packed", False), device=device,
        )
        for var_id, entry in manifest["vars"].items():
            rt.states[var_id] = _get_state(hs, var_id, rt.states[var_id], entry)
            # restored rows carry no row-level change provenance
            rt.mark_dirty(var_id)
        if n_replicas is not None and n_replicas != manifest["n_replicas"]:
            if neighbors is None:
                raise ValueError(
                    "restoring onto a different n_replicas requires a "
                    "matching neighbors topology"
                )
            rt.resize(n_replicas, neighbors)
        elif neighbors is not None:
            rt.resize(rt.n_replicas, neighbors)
        return rt


__all__ = [
    "load_runtime",
    "load_runtime_rows",
    "load_store",
    "loads_manifest",
    "save_runtime",
    "save_store",
]
