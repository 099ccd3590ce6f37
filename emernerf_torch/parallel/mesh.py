"""Ray-batch data parallelism over ``torch.distributed`` (port of
``emernerf_tpu/parallel/mesh.py``).

The JAX package lays a 1-D mesh over the chips of one host and lets XLA
place the collectives; here each device is driven by a process of its own
(a rank), parameters are replicated across the ranks, and every rank takes
an equal slice of each ray batch and of each eval render chunk.

The process group's backend follows the device: NCCL for CUDA tensors,
gloo for CPU tensors.  A caller may ask for gloo with CUDA tensors (NCCL
refuses two ranks on one device, as when two ranks share the one card).
Gloo then runs every collective on a host copy of the CUDA tensor: the
wrappers below copy to the host, run the collective there and copy back.
The route is chosen by the backend's name, never by catching an error.

``traffic`` counts what the wrappers sent: calls, bytes of their inputs,
and the host seconds spent in them (staging included; with NCCL the
collective is asynchronous, so only the host's share).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

# torch 2.13 renamed the tensor collectives; the card's torch may predate
# the new names
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


@dataclasses.dataclass
class Traffic:
    """Collectives sent by this process: calls, input bytes, host seconds."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


traffic = Traffic()


def world_size(num_devices: int, device) -> int:
    """The number of ranks ``parallel.num_devices`` asks for on ``device``:
    0 means every visible GPU.  Where each rank takes a card of its own (a
    CUDA device without an index), more ranks than visible cards raise."""
    n = int(num_devices)
    dev = torch.device(device)
    if n < 0:
        raise ValueError(f"parallel.num_devices={n} must be >= 0")
    if dev.type == "cuda" and dev.index is None:
        visible = torch.cuda.device_count()
        n = visible if n == 0 else n
        if n > visible or n == 0:
            raise ValueError(f"parallel.num_devices={num_devices} asks for {n} GPUs, "
                             f"{visible} visible")
    elif n == 0:
        raise ValueError("parallel.num_devices=0 (every visible GPU) needs device 'cuda'")
    return n


def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:rank`` for a CUDA device without an
    index, else ``device`` itself (every rank on the one named device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank)
    return dev


def init_data_parallel(num_devices: int, device, backend: Optional[str] = None,
                       init_method: Optional[str] = None, rank: Optional[int] = None):
    """Make (or join) the process group of ``parallel.num_devices`` ranks;
    returns ``(group, this rank's device)``.  ``device`` is as the user
    names it (see :func:`rank_device`); the rank's device type picks the
    backend (NCCL for CUDA, gloo otherwise) unless ``backend`` names one.
    ``init_method`` and ``rank`` default to torchrun's environment
    (``env://``, ``RANK``; the card from ``LOCAL_RANK``)."""
    n = world_size(num_devices, device)
    joined = dist.is_initialized()
    if joined and dist.get_world_size() != n:
        raise ValueError(f"the process group has {dist.get_world_size()} ranks, "
                         f"parallel.num_devices asks for {n}")
    if joined:
        rank = dist.get_rank()
    elif rank is None:
        rank = int(os.environ["RANK"])
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if not joined:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method=init_method or "env://", rank=rank, world_size=n)
    return dist.group.WORLD, dev


def rank_and_size(group):
    return dist.get_rank(group), dist.get_world_size(group)


def batch_slice(tensor: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s equal share of the leading axis."""
    n = tensor.shape[0]
    if n % world:
        raise ValueError(f"a leading axis of {n} does not split over {world} ranks")
    m = n // world
    return tensor[rank * m:(rank + 1) * m]


def _staged(group, t: torch.Tensor) -> bool:
    """Whether a collective on ``t`` runs on a host copy: gloo with a CUDA
    tensor."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _run(fn: Callable, group, out: torch.Tensor, inp: torch.Tensor) -> None:
    t0 = time.perf_counter()
    traffic.calls += 1
    traffic.bytes += inp.numel() * inp.element_size()
    if _staged(group, out):
        host_in = inp.cpu()
        host_out = host_in if inp is out else torch.empty(out.shape, dtype=out.dtype)
        fn(host_out, host_in)
        out.copy_(host_out)
    else:
        fn(out, inp)
    traffic.seconds += time.perf_counter() - t0


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` (a sum unless ``op`` says otherwise)."""
    _run(lambda o, _: dist.all_reduce(o, op=op, group=group), group, t, t)
    return t


def reduce_scatter(inp: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of ``inp``, cut along its leading axis: this
    rank's slab."""
    n = dist.get_world_size(group)
    out = torch.empty((inp.shape[0] // n, *inp.shape[1:]), dtype=inp.dtype, device=inp.device)
    _run(lambda o, i: _REDUCE_SCATTER(o, i, group=group), group, out, inp.contiguous())
    return out


def all_gather(inp: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``inp`` stacked along the leading axis in rank order."""
    n = dist.get_world_size(group)
    out = torch.empty((inp.shape[0] * n, *inp.shape[1:]), dtype=inp.dtype, device=inp.device)
    _run(lambda o, i: _ALL_GATHER(o, i, group=group), group, out, inp.contiguous())
    return out


def shard_render_chunk(render_chunk: Callable, group) -> Callable:
    """Wrap ``render_chunk(rays) -> outputs`` so that each rank renders its
    slice of the chunk and the outputs come back whole on every rank.
    Rendering is independent per ray: the chunk's outputs are the
    unsharded render's."""
    rank, n = rank_and_size(group)

    def wrapped(rays: Dict[str, torch.Tensor], *args, **kw) -> Dict[str, torch.Tensor]:
        part = render_chunk({k: batch_slice(v, rank, n) for k, v in rays.items()}, *args, **kw)
        return {k: all_gather(v, group) for k, v in part.items()}

    return wrapped
