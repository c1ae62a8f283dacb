"""vmbench: the benchmark of ``videomorphing_tpu_torch`` on an NVIDIA H100.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m vmbench.run --workload pair_1k.points4 --seed 7 --seconds 10 --trace 0

A cell names a configuration (``configs/<name>.json``, whose ``kind``
picks the module ``kinds/<kind>.py`` that drives it) and a traffic mix
(``mixes/<name>.json``); each per-layer metric is a reader of its own
(``metrics/<name>.py``). The yardstick lives here and nowhere in the
program: the inputs' formula (``inputs``), the roofline arithmetic
(``roofline``), the window and trace statistics (``stats``, ``trace``)
and the plain reference that decides ``correct`` (``reference/``).
"""
