"""EmerNeRF in PyTorch with hand-written CUDA kernels for Hopper.

The JAX package ``emernerf_tpu`` is the reference; module paths and names
here mirror it.  This package imports neither ``jax`` nor ``emernerf_tpu``:
it keeps its own copies of the framework-free modules it needs.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another (the CPU tests pass ``device="cpu"``).  Raises where that
    device is CUDA and this host has none; there is no quiet CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; "
            "pass device='cpu' to run the plain versions on the CPU")
    return dev
