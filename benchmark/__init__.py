"""The benchmark of monoloco_tpu_torch on one H100: `run.py` runs one cell of
`BENCHMARK.json`; PERF.md says what each cell and metric is for."""
