"""Erlang <-> Python bridge (port of ``lasp_tpu.bridge``): a protocol server
exposing this package's store to a BEAM node's ``lasp_backend`` behaviour
over ``{packet, 4}`` + External Term Format, plus the Python reference
client the conformance tests drive. The BEAM-side adapter is the JAX
package's ``lasp_tpu/bridge/erlang/lasp_tpu_backend.erl``: it speaks the
wire, not a package, so it serves both."""

from . import etf
from .etf import Atom
from .server import BridgeClient, BridgeServer

__all__ = ["Atom", "BridgeClient", "BridgeServer", "decode", "encode"]


def __getattr__(name):
    # the codec arm is chosen at first use: read it from the module then
    if name in ("encode", "decode"):
        return getattr(etf, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
