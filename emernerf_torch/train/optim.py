"""Optimizer and learning-rate schedule (port of ``emernerf_tpu/train/optim.py``).

Adam with L2 weight decay added to the gradient before the moments (torch
``Adam(weight_decay=...)``, not AdamW), betas (0.9, 0.99), eps 1e-15, fp32
update math, and bf16 moment STORAGE for fp32 params of 2^20 elements or
more (the grid tables: four in the brick flagship, five with separate
dynamic and flow grids); every other param keeps fp32 moments.  The
update runs per parameter tensor in the K8 kernel (``kernels/csrc/adam.cu``)
on the card and in :func:`adam_update_ref` on the CPU.  No ``torch.optim``.

The learning rate is applied separately so the pixel and lidar updates of
one iteration can use different scheduler counts (the reference steps its
torch scheduler after both).  Scalars the reference computes in float32
on the device (the bias corrections, the lr) are computed in float32 on the
host here.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from emernerf_torch import kernels

# params with at least this many elements store Adam moments in bf16
_BF16_MOMENT_MIN_ELEMS = 1 << 20


class AdamHyper(ctypes.Structure):
    """One update's scalars; mirror of ``AdamHyper`` in kernels/csrc/adam.cu."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "weight_decay", "b1", "one_minus_b1", "b2", "one_minus_b2", "c1", "c2", "eps",
        "neg_lr")]


def adam_update_ref(param: torch.Tensor, grad: Optional[torch.Tensor], mu: torch.Tensor,
                    nu: torch.Tensor, h: AdamHyper) -> None:
    """Plain version of :func:`adam_update`, op for op the kernel's."""
    p = param.detach()
    g = torch.zeros_like(p) if grad is None else grad
    g = g + p * h.weight_decay
    mu.copy_(mu.float() * h.b1 + g * h.one_minus_b1)
    nu.copy_(nu.float() * h.b2 + (g * h.one_minus_b2) * g)
    # divide by device scalars: a Python-number divisor may become a
    # multiplication by its reciprocal, which rounds differently
    c1, c2 = p.new_full((), h.c1), p.new_full((), h.c2)
    direction = (mu.float() / c1) / (torch.sqrt(nu.float() / c2) + h.eps)
    p.copy_(p + direction * h.neg_lr)


def adam_update(param: torch.Tensor, grad: Optional[torch.Tensor], mu: torch.Tensor,
                nu: torch.Tensor, h: AdamHyper) -> None:
    """In-place Adam update of one fp32 param tensor and its moments (fp32 or
    bf16); ``grad`` None is a zero gradient.  CPU tensors take the plain
    version; CUDA tensors launch the K8 kernel."""
    name = "adam_update"
    if param.dtype != torch.float32 or mu.dtype != nu.dtype or mu.shape != param.shape:
        raise ValueError(f"{name}: fp32 param with two moments of its shape")
    if kernels.dispatch_device(name, param) == "cpu":
        with torch.no_grad():
            adam_update_ref(param, grad, mu, nu, h)
        return
    extra = () if grad is None else (grad,)
    kernels.require_cuda_inputs(name, param, mu, nu, *extra)
    lib = kernels.load()
    err = lib.emt_adam(param.data_ptr(), None if grad is None else grad.data_ptr(),
                       mu.data_ptr(), nu.data_ptr(), int(mu.dtype == torch.bfloat16),
                       param.numel(), ctypes.addressof(h), kernels.stream_ptr(param.device))
    kernels.check(err, name)
    adam_update.launches += 1


adam_update.launches = 0


@dataclasses.dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class Adam:
    """L2-then-Adam direction with low-precision moment storage."""

    def __init__(self, weight_decay: float = 1e-5, b1: float = 0.9, b2: float = 0.99,
                 eps: float = 1e-15):
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps

    @staticmethod
    def _moment_like(p: torch.Tensor) -> torch.Tensor:
        if p.dtype == torch.float32 and p.numel() >= _BF16_MOMENT_MIN_ELEMS:
            return torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
        return torch.zeros_like(p, memory_format=torch.contiguous_format)

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(0, [self._moment_like(p) for p in params],
                         [self._moment_like(p) for p in params])

    def hyper(self, count: int, lr: float) -> AdamHyper:
        """The update's scalars, in float32 as the reference forms them."""
        f32 = np.float32
        c = f32(count)
        c1 = f32(1.0) - f32(self.b1) ** c
        c2 = f32(1.0) - f32(self.b2) ** c
        return AdamHyper(self.weight_decay, self.b1, 1.0 - self.b1, self.b2, 1.0 - self.b2,
                         float(c1), float(c2), self.eps, -float(f32(lr)))

    def update(self, grads: Sequence[Optional[torch.Tensor]], state: AdamState,
               params: Sequence[torch.Tensor], lr: float) -> None:
        """One Adam step of every param, in place; scaled by ``lr``."""
        state.count += 1
        h = self.hyper(state.count, lr)
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, state.mu, state.nu):
                adam_update(p, None if g is None else g.contiguous(), m, v, h)


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
