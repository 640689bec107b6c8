"""Measurement tools of the port: counterparts of the JAX package's
`tools/bench_pallas_int8.py`, `tools/bench_pallas_crossover.py`,
`tools/bench_roofline.py`, `tools/bench_serve.py`, `tools/bench_latency.py`
and `tools/bench_int8_crossover.py`, run as
`python -m monoloco_tpu_torch.tools.<name>` on a CUDA card."""
