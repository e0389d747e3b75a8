"""Store layer: the single-replica runtime core (port of ``lasp_tpu.store``;
persistence and the native host store are not ported yet)."""

from .store import PreconditionError, Store, Variable, Watch

__all__ = ["PreconditionError", "Store", "Variable", "Watch"]
