"""The control's rounding: with ``ROUND`` set to (forward dtype, backward
dtype), grid tables and MLP operands are rounded through the forward dtype
on their way into the computation, and the gradients flowing back through
the same points through the backward dtype, each tensor with its own scale
(its largest magnitude to the dtype's largest), as fp8 training scales
them (e4m3 forward, e5m2 backward); with ``ROUND`` None, nothing changes."""

import torch

ROUND = None


def _round(x, dtype):
    amax = x.detach().abs().amax().float()
    if not bool(torch.isfinite(amax)) or float(amax) == 0.0:
        return x
    scale = amax / torch.finfo(dtype).max
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, ROUND[0])

    @staticmethod
    def backward(ctx, g):
        return _round(g, ROUND[1])


def rnd(x):
    if ROUND is None:
        return x
    return _Round.apply(x) if x.requires_grad else _round(x, ROUND[0])
