"""The benchmark of ``lasp_tpu_torch`` on one NVIDIA H100.

``benchmark/run.py`` runs one cell of ``BENCHMARK.json`` once. Everything
that belongs to one configuration, one traffic mix or one per-layer metric
sits in a file of its own that the harness finds by name:

- ``configs/<config>.json``: the deployment's sizes, and the names of its
  population builder (``apps/<app>.py``, written against the port's public
  API) and of its plain reference (``reference/<reference>.py``, which
  imports nothing of the port);
- ``traffic/<mix>.json``: the parameters of one traffic mix, read by the
  general drivers and generator in ``harness/``;
- ``metrics/<metric>.py``: one per-layer metric's reader (a name
  ``base.cell`` falls back to ``metrics/<base>.py``).
"""
