"""The reference's built-in example programs, rebuilt.

- :class:`ExampleProgram` — OR-set accumulator of every notified object
  (``src/lasp_example_program.erl:38-61``; its internal type
  ``lasp_orset_gbtree`` is codec-identical to ``lasp_orset`` here).
- :class:`ExampleKeylistProgram` — G-set of keys seen
  (``src/lasp_example_keylist_program.erl:38-60``).
"""

from __future__ import annotations

from .base import Program


class ExampleProgram(Program):
    type_name = "lasp_orset_gbtree"

    def __init__(self, n_elems: int = 64):
        self.n_elems = n_elems
        self.id = None

    def init(self, session) -> None:
        self.id = session.declare(type=self.type_name, n_elems=self.n_elems)

    def process(self, session, object, reason, actor) -> None:
        # every event adds the object (src/lasp_example_program.erl:43-45)
        session.store.update(self.id, ("add", object), actor)

    def execute(self, session):
        return session.value(self.id)


class ExampleKeylistProgram(Program):
    type_name = "lasp_gset"

    def __init__(self, n_elems: int = 64):
        self.n_elems = n_elems
        self.id = None

    def init(self, session) -> None:
        self.id = session.declare(type=self.type_name, n_elems=self.n_elems)

    def process(self, session, object, reason, actor) -> None:
        # object events carry (key, value); the keylist keeps keys
        # (src/lasp_example_keylist_program.erl:43-45)
        key = object[0] if isinstance(object, tuple) else object
        session.store.update(self.id, ("add", key), actor)

    def execute(self, session):
        return session.value(self.id)
