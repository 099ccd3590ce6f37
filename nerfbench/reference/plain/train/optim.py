"""Optimizer and learning-rate schedule (port of ``emernerf_tpu/train/optim.py``),
the plain path of the port's K8 Adam with fp32 moments.

Adam with L2 weight decay added to the gradient before the moments (torch
``Adam(weight_decay=...)``, not AdamW), betas (0.9, 0.99), eps 1e-15, fp32
update math and fp32 moments for every parameter.  No ``torch.optim``.

The learning rate is applied separately so the pixel and lidar updates of
one iteration can use different scheduler counts (the reference steps its
torch scheduler after both).  Scalars the reference computes in float32
on the device (the bias corrections, the lr) are computed in float32 on the
host here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamHyper:
    """One update's scalars."""

    weight_decay: float
    b1: float
    one_minus_b1: float
    b2: float
    one_minus_b2: float
    c1: float
    c2: float
    eps: float
    neg_lr: float


def adam_update_ref(param: torch.Tensor, grad: Optional[torch.Tensor], mu: torch.Tensor,
                    nu: torch.Tensor, h: AdamHyper) -> None:
    """One Adam step of one parameter, in place, op for op the K8 kernel's."""
    p = param.detach()
    g = torch.zeros_like(p) if grad is None else grad
    g = g + p * h.weight_decay
    mu.copy_(mu * h.b1 + g * h.one_minus_b1)
    nu.copy_(nu * h.b2 + (g * h.one_minus_b2) * g)
    # divide by device scalars: a Python-number divisor may become a
    # multiplication by its reciprocal, which rounds differently
    c1, c2 = p.new_full((), h.c1), p.new_full((), h.c2)
    direction = (mu / c1) / (torch.sqrt(nu / c2) + h.eps)
    p.copy_(p + direction * h.neg_lr)


@dataclasses.dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class Adam:
    """L2-then-Adam direction with fp32 moments."""

    def __init__(self, weight_decay: float = 1e-5, b1: float = 0.9, b2: float = 0.99,
                 eps: float = 1e-15):
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        def zeros():
            return [torch.zeros_like(p, memory_format=torch.contiguous_format) for p in params]

        return AdamState(0, zeros(), zeros())

    def hyper(self, count: int, lr: float) -> AdamHyper:
        """The update's scalars, in float32 as the reference forms them."""
        f32 = np.float32
        c = f32(count)
        c1 = f32(1.0) - f32(self.b1) ** c
        c2 = f32(1.0) - f32(self.b2) ** c
        return AdamHyper(*(float(f32(v)) for v in (
            self.weight_decay, self.b1, 1.0 - self.b1, self.b2, 1.0 - self.b2, c1, c2,
            self.eps, -float(f32(lr)))))

    def update(self, grads: Sequence[Optional[torch.Tensor]], state: AdamState,
               params: Sequence[torch.Tensor], lr: float) -> None:
        """One Adam step of every param, in place; scaled by ``lr``."""
        state.count += 1
        h = self.hyper(state.count, lr)
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, state.mu, state.nu):
                adam_update_ref(p, None if g is None else g.contiguous(), m, v, h)


def make_adam(weight_decay: float = 1e-5) -> Adam:
    return Adam(weight_decay, b1=0.9, b2=0.99, eps=1e-15)


def chained_lr_schedule(base_lr: float, num_iters: int):
    """lr as a host function of the scheduler call count: linear warmup from
    0.01x over num_iters // 10 calls, x0.33 at each milestone."""
    milestones = [num_iters // 2, num_iters * 3 // 4, num_iters * 9 // 10]
    if num_iters >= 10000:
        milestones.insert(0, num_iters // 4)
    warmup = max(num_iters // 10, 1)
    f32 = np.float32

    def lr(count: int) -> float:
        c = f32(count)
        warm = f32(0.01) + f32(0.99) * np.minimum(c, f32(warmup)) / f32(warmup)
        n_hit = f32(sum(int(c >= m) for m in milestones))
        return float(f32(base_lr) * warm * f32(0.33) ** n_hit)

    return lr


def apply_update(tx: Adam, grads: Sequence[Optional[torch.Tensor]], opt_state: AdamState,
                 params: Sequence[torch.Tensor], lr: float) -> None:
    """One optimizer step: the Adam direction scaled by -lr, in place."""
    tx.update(grads, opt_state, params, lr)
