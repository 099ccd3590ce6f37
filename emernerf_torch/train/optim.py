"""Optimizer and learning-rate schedule (port of ``emernerf_tpu/train/optim.py``).

Adam with L2 weight decay added to the gradient before the moments (torch
``Adam(weight_decay=...)``, not AdamW), betas (0.9, 0.99), eps 1e-15, fp32
update math, and bf16 moment STORAGE for fp32 params of 2^20 elements or
more (the grid tables: four in the brick flagship, five with separate
dynamic and flow grids); every other param keeps fp32 moments.  The
update runs per parameter tensor in the K8 kernel (``kernels/csrc/adam.cu``)
on the card and in :func:`adam_update_ref` on the CPU.  No ``torch.optim``.
The data-parallel step of ``parallel/spmd.py`` takes its three updates from
the K11 kernels of the same file (:func:`spmd_adam_update`, every
replicated leaf of a group in one launch; :func:`zero_slab_update`;
:func:`apply_direction`), whose direction reads the unrounded fp32
moments, as ``emernerf_tpu/parallel/spmd.py`` does.  They access 16 bytes
per operand and thread where every operand is 16-byte aligned
(:func:`vector_width`), one element at a time otherwise.

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


def _scalars(p: torch.Tensor, h: AdamHyper):
    # divide by device scalars: a Python-number divisor may become a
    # multiplication by its reciprocal, which rounds differently
    return p.new_full((), h.c1), p.new_full((), h.c2)


def spmd_adam_update_ref(param: torch.Tensor, grad: Optional[torch.Tensor], mu: torch.Tensor,
                         nu: torch.Tensor, h: AdamHyper) -> None:
    """Plain version of :func:`spmd_adam_update`, op for op the kernel's."""
    p = param.detach()
    g = torch.zeros_like(p) if grad is None else grad
    g = g + p * h.weight_decay
    m = mu.float() * h.b1 + g * h.one_minus_b1
    v = nu.float() * h.b2 + (g * h.one_minus_b2) * g
    mu.copy_(m)
    nu.copy_(v)
    c1, c2 = _scalars(p, h)
    p.copy_(p + ((m / c1) / (torch.sqrt(v / c2) + h.eps)) * h.neg_lr)


def zero_slab_update_ref(slab: torch.Tensor, p_local: torch.Tensor, mu: torch.Tensor,
                         nu: torch.Tensor, dir_out: torch.Tensor, n_ranks: int,
                         h: AdamHyper) -> None:
    """Plain version of :func:`zero_slab_update`, op for op the kernel's."""
    g = slab.float() / p_local.new_full((), float(n_ranks))
    g = g + p_local * h.weight_decay
    m = mu.float() * h.b1 + g * h.one_minus_b1
    v = nu.float() * h.b2 + (g * h.one_minus_b2) * g
    mu.copy_(m)
    nu.copy_(v)
    c1, c2 = _scalars(p_local, h)
    dir_out.copy_((m / c1) / (torch.sqrt(v / c2) + h.eps))


def apply_direction_ref(param: torch.Tensor, direction: torch.Tensor, neg_lr: float) -> None:
    """Plain version of :func:`apply_direction`."""
    p = param.detach()
    p.copy_(p + direction.float() * neg_lr)


def _check_spmd_leaf(name, p: torch.Tensor, g: Optional[torch.Tensor], m: torch.Tensor,
                     v: torch.Tensor) -> None:
    if p.dtype != torch.float32:
        raise ValueError(f"{name}: fp32 params, not {p.dtype}")
    _check_moments(name, p, m, v)
    if g is not None and g.shape != p.shape:
        raise ValueError(f"{name}: a gradient {tuple(g.shape)} of a {tuple(p.shape)} param")


def _check_moments(name, ref: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor) -> None:
    if mu.dtype != nu.dtype or mu.shape != ref.shape or nu.shape != ref.shape:
        raise ValueError(f"{name}: two moments of one dtype and of the shape {tuple(ref.shape)}")
    if mu.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: moments fp32 or bf16, not {mu.dtype}")


# leaf descriptors per K11 multi-leaf launch (kMaxLeaves in adam.cu)
SPMD_LEAVES_PER_LAUNCH = 64


class SpmdLeaf(ctypes.Structure):
    """One replicated leaf of a K11 launch; mirror of ``LeafDesc`` in
    kernels/csrc/adam.cu (``first_chunk`` is filled there)."""

    _fields_ = [("param", ctypes.c_void_p), ("grad", ctypes.c_void_p), ("mu", ctypes.c_void_p),
                ("nu", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("first_chunk", ctypes.c_longlong), ("moments_bf16", ctypes.c_int),
                ("vec", ctypes.c_int)]


def _width(ptrs) -> int:
    return 8 if all(x % 16 == 0 for x in ptrs) else 1


def vector_width(*tensors: torch.Tensor) -> int:
    """K11's access width: 8 elements (16-byte vectors) where every operand
    starts 16-byte aligned, else 1 (the same kernel, one element at a
    time).  Any element count works: a scalar tail follows the vectors."""
    return _width(t.data_ptr() for t in tensors)


def spmd_adam_update(params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]],
                     mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
                     h: AdamHyper) -> None:
    """In-place Adam step of replicated fp32 params whose direction reads the
    unrounded fp32 moments (K11; a ``grads`` entry None is a zero
    gradient).  CPU tensors take the plain version, leaf by leaf; CUDA
    tensors launch the kernel once per ``SPMD_LEAVES_PER_LAUNCH`` leaves."""
    name = "spmd_adam_update"
    if not len(params) == len(grads) == len(mus) == len(nus):
        raise ValueError(f"{name}: one gradient and two moments per param")
    if not params:
        return
    if kernels.dispatch_device(name, params[0]) == "cpu":
        for p, g, m, v in zip(params, grads, mus, nus):
            _check_spmd_leaf(name, p, g, m, v)
            if any(t is not None and t.device.type != "cpu" for t in (p, g, m, v)):
                raise ValueError(f"{name}: every leaf on the CPU, or every leaf on one "
                                 "CUDA device")
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, mus, nus):
                spmd_adam_update_ref(p, g, m, v, h)
        return
    # one pass per leaf: its checks, then its descriptor
    dev = params[0].get_device()
    leaves = []
    for p, g, m, v in zip(params, grads, mus, nus):
        _check_spmd_leaf(name, p, g, m, v)
        ts = (p, m, v) if g is None else (p, m, v, g)
        ptrs = []
        for t in ts:
            if t.get_device() != dev or not t.is_contiguous():
                raise ValueError(f"{name}: contiguous tensors on one CUDA device")
            ptrs.append(t.data_ptr())
        leaves.append((ptrs[0], ptrs[3] if g is not None else None, ptrs[1], ptrs[2],
                       p.numel(), 0, int(m.dtype == torch.bfloat16), _width(ptrs)))
    lib, stream = kernels.load(), kernels.stream_ptr(params[0].device)
    for i in range(0, len(leaves), SPMD_LEAVES_PER_LAUNCH):
        part = leaves[i:i + SPMD_LEAVES_PER_LAUNCH]
        table = (SpmdLeaf * len(part))(*part)
        kernels.check(lib.emt_spmd_adam_multi(ctypes.addressof(table), len(part),
                                              ctypes.addressof(h), stream), name)
        spmd_adam_update.launches += 1


def zero_slab_update(slab: torch.Tensor, p_local: torch.Tensor, mu: torch.Tensor,
                     nu: torch.Tensor, dir_out: torch.Tensor, n_ranks: int,
                     h: AdamHyper) -> None:
    """This rank's Adam step of a ZeRO-routed leaf (K11): the reduce-scattered
    gradient sum ``slab`` (fp32 or bf16, the wire's dtype) over ``n_ranks``,
    plus the L2 term of the param rows ``p_local`` (fp32), updates the moment
    shard in place and writes the direction, rounded to ``dir_out``'s dtype
    (fp32 or bf16).  CPU tensors take the plain version."""
    name = "zero_slab_update"
    if p_local.dtype != torch.float32 or slab.shape != p_local.shape:
        raise ValueError(f"{name}: an fp32 param slab of the gradient slab's shape")
    if slab.dtype not in (torch.float32, torch.bfloat16) or dir_out.dtype not in (
            torch.float32, torch.bfloat16) or dir_out.shape != slab.shape:
        raise ValueError(f"{name}: fp32 or bf16 gradient and direction slabs of one shape")
    _check_moments(name, slab, mu, nu)
    if kernels.dispatch_device(name, slab) == "cpu":
        with torch.no_grad():
            zero_slab_update_ref(slab, p_local, mu, nu, dir_out, n_ranks, h)
        return
    kernels.require_cuda_inputs(name, slab, p_local, mu, nu, dir_out)
    bf16 = torch.bfloat16
    err = kernels.load().emt_zero_slab(
        slab.data_ptr(), int(slab.dtype == bf16), p_local.data_ptr(), mu.data_ptr(),
        nu.data_ptr(), int(mu.dtype == bf16), dir_out.data_ptr(), int(dir_out.dtype == bf16),
        slab.numel(), float(n_ranks), ctypes.addressof(h),
        vector_width(slab, p_local, mu, nu, dir_out), kernels.stream_ptr(slab.device))
    kernels.check(err, name)
    zero_slab_update.launches += 1


def apply_direction(param: torch.Tensor, direction: torch.Tensor, neg_lr: float) -> None:
    """``param += neg_lr * direction`` in place (K11), the gathered direction
    fp32 or bf16.  CPU tensors take the plain version."""
    name = "apply_direction"
    if param.dtype != torch.float32 or direction.shape != param.shape or direction.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: an fp32 param and an fp32 or bf16 direction of its shape")
    if kernels.dispatch_device(name, param) == "cpu":
        with torch.no_grad():
            apply_direction_ref(param, direction, neg_lr)
        return
    kernels.require_cuda_inputs(name, param, direction)
    err = kernels.load().emt_apply_direction(
        param.data_ptr(), direction.data_ptr(), int(direction.dtype == torch.bfloat16),
        param.numel(), float(neg_lr), vector_width(param, direction),
        kernels.stream_ptr(param.device))
    kernels.check(err, name)
    apply_direction.launches += 1


spmd_adam_update.launches = 0
zero_slab_update.launches = 0
apply_direction.launches = 0


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
