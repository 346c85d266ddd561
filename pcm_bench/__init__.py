"""The benchmark of the PyTorch / CUDA port (`pcm_tpu_torch`) on NVIDIA H100s.

    python3 -m pcm_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the repository's root names the cells, the end-to-end
metrics (with their bounds) and the per-layer metrics. Everything that
belongs to one cell, configuration, traffic mix or per-layer metric is a
file of its own, found by name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``traffic/<driver>.py`` and
``layer_metrics/<metric>.py``. ``reference/`` is the plain PyTorch reference
that decides whether a run's outputs are correct; it imports nothing of
the program.
"""
