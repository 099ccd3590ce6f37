"""Data parallelism over ``torch.distributed`` (port of
``emernerf_tpu/parallel``): the process group and the batch and render
sharding (:mod:`.mesh`), and the explicit-collective optimizer step with
bf16 gradient reduction and ZeRO-sharded Adam moments (:mod:`.spmd`)."""

from emernerf_torch.parallel.mesh import (
    all_gather,
    all_reduce_,
    batch_slice,
    init_data_parallel,
    rank_device,
    reduce_scatter,
    shard_render_chunk,
    world_size,
)
from emernerf_torch.parallel.spmd import SpmdConfig

__all__ = [
    "SpmdConfig",
    "all_gather",
    "all_reduce_",
    "batch_slice",
    "init_data_parallel",
    "rank_device",
    "reduce_scatter",
    "shard_render_chunk",
    "world_size",
]
