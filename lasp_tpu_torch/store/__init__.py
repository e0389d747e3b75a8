"""Store layer: the single-replica runtime core and its persistence (port of
``lasp_tpu.store``)."""

from .checkpoint import (
    load_runtime,
    load_runtime_rows,
    load_store,
    save_runtime,
    save_store,
)
from .host_store import HostStore
from .store import PreconditionError, Store, Variable, Watch

__all__ = [
    "HostStore",
    "PreconditionError",
    "Store",
    "Variable",
    "Watch",
    "load_runtime",
    "load_runtime_rows",
    "load_store",
    "save_runtime",
    "save_store",
]
