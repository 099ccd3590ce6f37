"""Density activations (port of ``emernerf_tpu/ops/activations.py``).

``trunc_exp``: forward ``exp(x)``; backward ``g * exp(min(x, 15))`` so the
gradient cannot blow up.
"""

import torch


class TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(max=15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return TruncExp.apply(x)


def density_activation(x: torch.Tensor) -> torch.Tensor:
    """The density head activation: ``trunc_exp(x - 1)``."""
    return trunc_exp(x - 1.0)
