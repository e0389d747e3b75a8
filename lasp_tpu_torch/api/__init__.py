"""Public API (L4): the Lasp verb set (``src/lasp.erl``); port of ``lasp_tpu.api``."""

from .session import Session

__all__ = ["Session"]
