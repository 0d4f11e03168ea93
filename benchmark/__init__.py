"""The serving benchmark of ``wis_tpu_torch`` on one NVIDIA GPU.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix or
per-layer metric is a file of its own, found by the name the cell gives:

- ``configs/<config>.json``: the model's sizes, its source, the cuts, the
  deployment settings and the limits of the correctness check, and
  ``system``, the module under ``systems/`` that serves it;
- ``traffic/<traffic>.json``: the parameters ``traffic.py`` draws a run's
  requests from;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``reference/``: the plain PyTorch references the served outputs are
  judged against; they import nothing of the program.
"""
