"""The benchmark of ``nerf_tpu_torch`` on one NVIDIA H100: ``run.py`` runs
one cell of ``BENCHMARK.json``; everything a cell, a configuration, a
traffic mix, a per-layer metric or a model type needs lives in a file of its
own here, found by its name."""
