"""``jnp.clip`` with JAX's gradient at the bounds.

``jnp.clip(x, lo, hi)`` is ``minimum(maximum(x, lo), hi)``, and JAX splits
the gradient of ``maximum``/``minimum`` evenly at a tie: where ``x`` equals a
bound the clip passes half the cotangent.  ``torch.clamp`` passes all of it.
The difference shows wherever a clipped value sits exactly on its bound,
e.g. the opacity of an opaque ray (its weights sum to exactly 1.0 in fp32)
or a sky ray's opacity at 1e-6.  :func:`clip` is ``clamp`` forward with
JAX's backward.
"""

from __future__ import annotations

from typing import Optional

import torch


def _side(x: torch.Tensor, above: torch.Tensor, tie: torch.Tensor) -> torch.Tensor:
    """1 strictly inside, 0.5 at the bound, 0 outside."""
    return (above.to(x.dtype) + tie.to(x.dtype)) * 0.5


class _Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        scale = torch.ones_like(x)
        if ctx.lo is not None:
            scale = scale * _side(x, x > ctx.lo, x >= ctx.lo)
        if ctx.hi is not None:
            scale = scale * _side(x, x < ctx.hi, x <= ctx.hi)
        return g * scale, None, None


def clip(x: torch.Tensor, lo: Optional[float] = None,
         hi: Optional[float] = None) -> torch.Tensor:
    """``x.clamp(lo, hi)`` whose backward passes 0.5 where ``x`` equals a
    bound, as ``jax.grad`` of ``jnp.clip`` does."""
    return _Clip.apply(x, lo, hi)
