"""Measurement tools of the port: counterparts of the JAX package's
`tools/bench_pallas_int8.py`, `tools/bench_pallas_crossover.py` and
`tools/bench_roofline.py`, run as `python -m monoloco_tpu_torch.tools.<name>`
on a CUDA card."""
