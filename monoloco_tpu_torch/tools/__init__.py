"""Tools of the port, run as `python -m monoloco_tpu_torch.tools.<name>`:
counterparts of the JAX package's `tools/bench_pallas_int8.py`,
`tools/bench_pallas_crossover.py`, `tools/bench_roofline.py`,
`tools/bench_serve.py`, `tools/bench_latency.py`,
`tools/bench_int8_crossover.py`, `tools/bench_variance.py` and
`tools/bench_int8_roofline.py`, which measure on a CUDA card, and of
`tools/make_synthetic_kitti.py`, `tools/eval_parity.py`,
`tools/export_torch.py`, `tools/bench_generate_full_scale.py`,
`tools/bench_cli_phases.py`, `tools/bench_hyp_search.py`,
`tools/bench_mesh_scaling.py` and `tools/train_tiny_reid.py`, which run on
the CPU too (`--disable-cuda` where a card is otherwise needed).
`tests/test_torch_tools.py` says what each other JAX tool maps to."""

import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_name(disable_cuda):
    """What a driver's record names as its device: 'cpu', or the card's name."""
    if disable_cuda:
        return 'cpu'
    import torch
    return torch.cuda.get_device_name(0)


def sync(device):
    """Wait for `device`'s queued work (nothing to wait for on the CPU)."""
    import torch
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)
