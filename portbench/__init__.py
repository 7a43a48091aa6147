"""The benchmark of `recommenders_tpu_torch` on an NVIDIA H100.

`run.py` runs one cell of `BENCHMARK.json`; everything that belongs to a
configuration, a traffic mix, a cell or a per-layer metric is a file of
its own under `configs/`, `traffic/`, `workloads/` and `metrics/`,
found by the name the manifest gives.
"""
