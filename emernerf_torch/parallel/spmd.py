"""Explicit-collective data-parallel optimizer step: bf16 gradient
reduction and ZeRO (port of ``emernerf_tpu/parallel/spmd.py``).

The JAX trainer's default multi-chip step (``parallel.explicit_collectives``)
places its collectives by hand inside a ``shard_map``; here they are
``torch.distributed`` calls between the ranks:

- every gradient that is not ZeRO-routed is averaged across the ranks in
  the wire dtype (``grad_psum_dtype``): summed and divided by the rank
  count in that dtype, then cast to fp32.  The port flattens them into one
  bucket, so a branch makes one all-reduce, not one per tensor;
- with ``zero``, a ZeRO-routed leaf's gradient is reduce-scattered in the
  wire dtype, each rank runs Adam on its slab of rows (its moments are
  that slab only, 1/n of the leaf), and the directions are all-gathered in
  ``direction_dtype`` and applied.

A leaf is ZeRO-routed when the JAX leaf has at least ``zero_min_elems``
elements and a leading dim that divides by the rank count; in the
flagship those are the grid tables.  Routing and slabs follow the JAX
leaf's layout, which is the transpose of the port's for a Linear's weight
(flax's kernel is (in, out)): such a leaf is sharded along the port
tensor's last dim.

Adam is the JAX package's: L2 weight decay added to the gradient, betas
(0.9, 0.99), eps 1e-15, the direction from the unrounded fp32 moments,
bf16 moment storage for fp32 leaves of 2^20 elements or more.  The updates
are the K11 kernels (``train/optim.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from emernerf_torch.parallel import mesh
from emernerf_torch.train.optim import (
    _BF16_MOMENT_MIN_ELEMS,
    Adam,
    AdamState,
    apply_direction,
    spmd_adam_update,
    zero_slab_update,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"wire dtype {name!r}: one of {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class SpmdConfig:
    """How the train step communicates across the ranks; the fields and
    defaults of the JAX package's ``SpmdConfig``.

    grad_psum_dtype: wire dtype of the gradient reduction ("float32" or
      "bfloat16"); the update math is fp32.
    zero: reduce-scatter the big leaves' gradients and shard their Adam
      moments over the ranks; all-gather the update direction.
    direction_dtype: wire dtype of the all-gathered ZeRO direction.
    zero_min_elems: leaves smaller than this stay replicated.
    """

    axis_name: str = "data"
    grad_psum_dtype: str = "bfloat16"
    zero: bool = False
    direction_dtype: str = "bfloat16"
    zero_min_elems: int = _BF16_MOMENT_MIN_ELEMS

    @property
    def wire_dtype(self) -> torch.dtype:
        return _dtype(self.grad_psum_dtype)

    @property
    def dir_dtype(self) -> torch.dtype:
        return _dtype(self.direction_dtype)


def _is_big(shape: Sequence[int], n_shards: int, min_elems: int) -> bool:
    """Whether a leaf of the JAX layout ``shape`` is ZeRO-routed."""
    return len(shape) >= 1 and math.prod(shape) >= min_elems and shape[0] % n_shards == 0


def transposed_params(*modules: nn.Module) -> List[bool]:
    """Per parameter of ``modules`` (in ``parameters()`` order): whether the
    JAX leaf is its transpose (a Linear's weight)."""
    flags = []
    for m in modules:
        linear = {id(x.weight) for x in m.modules() if isinstance(x, nn.Linear)}
        flags += [id(p) in linear for p in m.parameters()]
    return flags


def _jax_view(t: torch.Tensor, transposed: bool) -> torch.Tensor:
    return t.t() if transposed else t


@dataclasses.dataclass(frozen=True)
class Routing:
    """How one parameter list travels: per parameter, whether the JAX leaf is
    the port tensor's transpose and whether it is ZeRO-routed."""

    transposed: Tuple[bool, ...]
    big: Tuple[bool, ...]


def routing(params: Sequence[torch.Tensor], transposed: Sequence[bool], spmd: SpmdConfig,
            n_shards: int) -> Routing:
    big = tuple(spmd.zero and _is_big(tuple(_jax_view(p, t).shape), n_shards,
                                      spmd.zero_min_elems)
                for p, t in zip(params, transposed))
    return Routing(tuple(transposed), big)


def reduce_grads(params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]],
                 big: Sequence[bool], wire: torch.dtype, group) -> List[Optional[torch.Tensor]]:
    """The cross-rank mean of every gradient but the ZeRO-routed ones
    (returned as they came), in ``wire``: one all-reduce of all of them
    flattened, divided by the rank count in ``wire``, then fp32.  A missing
    gradient is a zero gradient."""
    small = [i for i, b in enumerate(big) if not b]
    out = list(grads)
    if not small:
        return out
    flat = torch.cat([(grads[i] if grads[i] is not None else torch.zeros_like(params[i]))
                      .reshape(-1).to(wire) for i in small])
    mesh.all_reduce_(flat, group)
    flat = flat.div_(dist.get_world_size(group)).float()
    for i, part in zip(small, flat.split([params[i].numel() for i in small])):
        out[i] = part.view(params[i].shape)
    return out


def spmd_apply_update(grads: Sequence[Optional[torch.Tensor]], opt_state: AdamState,
                      params: Sequence[torch.Tensor], lr: float, route: Routing,
                      spmd: SpmdConfig, group, tx: Adam) -> None:
    """One Adam step of ``params`` in place, scaled by ``lr``.  ``grads`` have
    been through :func:`reduce_grads` (the ZeRO-routed ones are still this
    rank's own); the ZeRO-routed moments of ``opt_state`` are this rank's
    slabs (:func:`shard_moments`)."""
    rank, n = mesh.rank_and_size(group)
    opt_state.count += 1
    h = tx.hyper(opt_state.count, lr)
    with torch.no_grad():
        # every replicated leaf in one K11 launch
        rep = [i for i, big in enumerate(route.big) if not big]
        spmd_adam_update([params[i] for i in rep],
                         [None if grads[i] is None else grads[i].contiguous() for i in rep],
                         [opt_state.mu[i] for i in rep], [opt_state.nu[i] for i in rep], h)
        # the ZeRO-routed ones each after their own reduce-scatter
        for i, (p, g, m, v) in enumerate(zip(params, grads, opt_state.mu, opt_state.nu)):
            if not route.big[i]:
                continue
            tr = route.transposed[i]
            g = torch.zeros_like(p) if g is None else g
            slab = mesh.reduce_scatter(_jax_view(g, tr).to(spmd.wire_dtype), group)
            p_local = mesh.batch_slice(_jax_view(p, tr), rank, n).contiguous()
            direction = torch.empty(slab.shape, dtype=spmd.dir_dtype, device=slab.device)
            zero_slab_update(slab, p_local, m, v, direction, n, h)
            full = mesh.all_gather(direction, group)
            apply_direction(p, _jax_view(full, tr).contiguous(), h.neg_lr)


def shard_moments(adam: AdamState, route: Routing, rank: int, n: int) -> None:
    """In place: each ZeRO-routed moment becomes this rank's rows of its JAX
    layout (a copy; the whole moment is released)."""
    for moments in (adam.mu, adam.nu):
        for i, big in enumerate(route.big):
            if big:
                rows = mesh.batch_slice(_jax_view(moments[i], route.transposed[i]), rank, n)
                moments[i] = rows.clone(memory_format=torch.contiguous_format)


def gather_moments(adam: AdamState, route: Routing, group) -> AdamState:
    """The whole moments of ``adam`` in the port's layout, as one process
    stores them (a collective: every rank joins)."""
    def whole(moments):
        return [_jax_view(mesh.all_gather(m, group), t).contiguous() if big else m
                for m, big, t in zip(moments, route.big, route.transposed)]

    return AdamState(adam.count, whole(adam.mu), whole(adam.nu))


def moment_rows(full: torch.Tensor, route: Routing, i: int, group) -> torch.Tensor:
    """This rank's rows of leaf ``i``'s whole moment ``full`` (port layout)
    where it is ZeRO-routed, else ``full``."""
    if not route.big[i]:
        return full
    rank, n = mesh.rank_and_size(group)
    return mesh.batch_slice(_jax_view(full, route.transposed[i]), rank, n)


@dataclasses.dataclass(frozen=True)
class ZeroLayout:
    """The ZeRO layout of a ``TrainState``'s moments: the routing of the
    model's and of the proposal nets' parameters, and the process group."""

    group: object
    model: Routing
    prop: Routing


def shard_state(state, spmd: SpmdConfig, group):
    """Lay a fresh ``TrainState``'s moments out for ``spmd``: under ZeRO the
    routed moments become this rank's slabs (1/n of their memory) and
    ``state.zero`` records the layout.  Returns the state."""
    if not spmd.zero:
        return state
    rank, n = mesh.rank_and_size(group)
    model = routing(state.params, transposed_params(state.model), spmd, n)
    prop = routing(state.prop_params, transposed_params(*state.prop_models), spmd, n)
    shard_moments(state.opt_state, model, rank, n)
    shard_moments(state.prop_opt_state, prop, rank, n)
    state.zero = ZeroLayout(group, model, prop)
    return state
