"""The program behaviour contract (``src/lasp_program.erl:29-46``)."""

from __future__ import annotations


class Program:
    """Base class mirroring the ``lasp_program`` behaviour callbacks.

    Lifecycle: ``init`` declares whatever variables the program owns;
    ``process`` receives object-change notifications (the riak_kv
    put/delete/handoff hook path, ``src/lasp.erl:129-150``); ``execute``
    returns the current result; ``value`` post-filters it; ``type`` names
    the result CRDT."""

    #: result CRDT type (``type/0``)
    type_name: str = "lasp_orset"

    def init(self, session) -> None:
        """``init/1``: declare owned variables against the session."""
        raise NotImplementedError

    def process(self, session, object, reason, actor) -> None:
        """``process/5``: fold one object event into program state."""
        raise NotImplementedError

    def execute(self, session):
        """``execute/2``: current result (decoded value)."""
        raise NotImplementedError

    def value(self, output):
        """``value/1``: optional post-filter; identity by default."""
        return output
