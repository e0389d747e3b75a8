"""Active anti-entropy (port of ``lasp_tpu.aae``): vectorized Merkle
hashtrees, pairwise tree exchange and targeted quorum repair.

- :mod:`.hashtree` — per-replica row hashes on the runtime's device, equal
  to JAX's bit for bit, and the host tree levels, rehashed incrementally
  from the runtime's dirty bookkeeping;
- :mod:`.exchange` — pairwise root -> segment -> leaf walks,
  hypercube-paired within the chaos mask's live components (one numpy pass
  a stride);
- :mod:`.repair` — divergence joins, corruption escalation to a quorum
  overwrite, and the :class:`AAEScrubber` driver.
"""

from .exchange import exchange_pair, sweep
from .hashtree import HashForest, group_row_hashes, row_hashes, subset_row_hashes
from .repair import AAEScrubber, overwrite_row

__all__ = [
    "AAEScrubber",
    "HashForest",
    "exchange_pair",
    "group_row_hashes",
    "overwrite_row",
    "row_hashes",
    "subset_row_hashes",
    "sweep",
]
