"""Programs layer (L5): distributed incremental programs (a copy of
``lasp_tpu.programs``, which uses numpy and hashlib only).

Rebuild of the ``lasp_program`` behaviour (``src/lasp_program.erl:29-46``):
``init/1, process/5, execute/2, value/1, type/0``. The reference compiles
program source on every partition and hot-loads it (``src/lasp_vnode.erl:
276-366``) because BEAM ships code at runtime; here a program is a plain
Python class whose writes go through the runtime's write path — no
deployment step.
"""

from .base import Program
from .examples import ExampleKeylistProgram, ExampleProgram
from .riak_index import RiakIndexProgram, RiakObject, view_name

__all__ = [
    "Program",
    "ExampleProgram",
    "ExampleKeylistProgram",
    "RiakIndexProgram",
    "RiakObject",
    "view_name",
]
