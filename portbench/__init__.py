"""The benchmark of ``libldpc_tpu_torch`` on one NVIDIA H100: a data-driven
harness (``run.py``), its cells, configurations, traffic mixes and
per-layer metrics as files found by name, and the plain reference that
decides whether a run's output is correct (``reference/``)."""
