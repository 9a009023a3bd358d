"""The benchmark of ``pcx_torch`` on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the checkout's root names the cells, the metrics and
their bounds; everything that belongs to one configuration, traffic mix,
per-layer metric or cell's limits is a file of its own here, found by its
name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` (the part of the name before the first dot) and
``limits/<cell>.json``.  The plain complex128 reference that decides
``correct`` is ``reference/``; it imports nothing of the program.
"""
