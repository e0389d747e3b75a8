"""lasp_tpu_torch — the PyTorch / CUDA port of ``lasp_tpu`` for one NVIDIA
H100.

The JAX package ``lasp_tpu`` stays the reference; this package keeps its
module paths and names so each port has an obvious counterpart, and is
held bit-for-bit against it by ``tests/test_torch_*.py``. It imports
``torch`` and numpy only — never ``jax`` and never ``lasp_tpu``.

Layer map (the slice ported so far):

- ``lasp_tpu_torch.lattice`` — CRDT tensor codecs (G-Set, G-Counter, I-Var,
  OR-Set, OR-SWOT, the CRDT map)
- ``lasp_tpu_torch.ops``     — packed / flat OR-Sets, the hand-written CUDA
  gossip kernels (``ops.cuda_gossip``) and the fused round loops
- ``lasp_tpu_torch.mesh``    — topologies, gossip rounds, the dispatch plan
  and the ``ReplicatedRuntime`` dense and frontier engines, with dataflow
  edges and reactive triggers in its step, the write path, the row and
  membership verbs (``join_rows``, ``reseed_row``, ``resize``, staged
  grow / drop)
- ``lasp_tpu_torch.membership`` — the claim rule, the row-scoped
  frontier degrade, staged plans, the handoff engine, the
  ``MembershipCoordinator``, its invariant harness and the typed errors
- ``lasp_tpu_torch.chaos``   — seeded fault timelines, ``ChaosRuntime``
  (crash / restore, degraded reads with read-repair, fused mask windows,
  soaks) and the convergence-under-failure invariants
- ``lasp_tpu_torch.quorum``  — the quorum request FSMs (N=3, R=W=2) as a
  batched tensor step, hinted handoff and the epoch fence
- ``lasp_tpu_torch.aae``     — active anti-entropy: row hashes on the card,
  the incremental hash forest, the tree exchange and ``AAEScrubber``
- ``lasp_tpu_torch.serve``   — the serving front-end: admission and the
  degradation ladder, batched threshold watches, ``ServeFrontend``,
  ``ServeLoop`` and the open-loop load harness
- ``lasp_tpu_torch.telemetry`` — the metric registry, spans, the causal
  event log, Prometheus export and the convergence monitor
- ``lasp_tpu_torch.store``   — the variable store, binds and threshold
  watches, the host store and checkpoints in the JAX package's format
- ``lasp_tpu_torch.dataflow``— the combinator graph (map / fold / filter /
  union / intersection / product / bind_to) and its fused propagate
- ``lasp_tpu_torch.bench_scenarios`` — the OR-Set anti-entropy headline,
  the ad counters (the 10M-replica north star included) and the scenarios
  of every ported layer
- ``lasp_tpu_torch.bridge_state``    — numpy state exchange with the JAX
  package's state pytrees
- ``lasp_tpu_torch.api``     — the public Lasp verb set (``Session``)
- ``lasp_tpu_torch.programs`` — Lasp's distributed incremental programs
- ``lasp_tpu_torch.bridge``  — the Erlang ``lasp_backend`` bridge: the ETF
  wire codec and the ``{packet, 4}`` server and client
- ``lasp_tpu_torch.config``  — the typed ``LASP_*`` configuration
- ``lasp_tpu_torch.cli``     — the console, ``python -m lasp_tpu_torch.cli``

Every entry point takes ``device=None``, meaning CUDA; without CUDA it
raises unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

# Lazy submodule / attribute loading (PEP 562), as the JAX package does:
# importing the package builds nothing and touches no device.
_SUBMODULES = frozenset({
    "aae", "api", "bench_scenarios", "bridge", "bridge_state", "chaos", "cli",
    "config", "dataflow", "device", "lattice", "membership", "mesh", "ops",
    "programs", "quorum", "serve", "store", "telemetry", "utils",
})
_ATTRS = {
    "Session": ("api", "Session"),
    "LaspConfig": ("config", "LaspConfig"),
    "get_config": ("config", "get_config"),
}


def __getattr__(name):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _ATTRS:
        mod, attr = _ATTRS[name]
        return getattr(importlib.import_module(f".{mod}", __name__), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | _SUBMODULES | set(_ATTRS))
