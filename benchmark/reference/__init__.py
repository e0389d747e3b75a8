"""Plain references of the benchmark's configurations: Python sets, dicts
and NumPy only. They import neither ``jax`` nor ``lasp_tpu`` nor anything
of ``lasp_tpu_torch``, and take nothing the program made: they are handed
the same generated inputs (writes, op schedules, the cycles they landed
in) and work the CRDT semantics out again by themselves."""
