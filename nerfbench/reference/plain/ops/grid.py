"""Grid-encoder dispatch on the spec type (port of ``emernerf_tpu/ops/grid.py``).

``BrickGridSpec`` -> the brick grid (K1), ``HashGridSpec`` -> the exact
tiny-cuda-nn hash grid (K4), the two grids of the benchmark's
configurations.  ``grid_encode(table, positions, spec, compute_dtype)``
takes the table as stored (the fp32 parameter) and encodes as
``table.to(compute_dtype)`` would.
"""

from __future__ import annotations

import torch

from nerfbench.reference.plain.ops import lowp

from nerfbench.reference.plain.ops.brickgrid import (
    BrickGridSpec,
    brickgrid_encode,
    init_brickgrid_table,
)
from nerfbench.reference.plain.ops.hashgrid import HashGridSpec, hashgrid_encode, init_hashgrid_table


def _hash_encode(table, positions, spec, compute_dtype=None):
    return hashgrid_encode(table if compute_dtype is None else table.to(compute_dtype),
                           positions, spec)


_BACKENDS = {
    BrickGridSpec: (brickgrid_encode, init_brickgrid_table),
    HashGridSpec: (_hash_encode, init_hashgrid_table),
}


def _backend(spec):
    try:
        return _BACKENDS[type(spec)]
    except KeyError:
        raise NotImplementedError(
            f"{type(spec).__name__}: not a grid spec") from None


def grid_encode(table: torch.Tensor, positions: torch.Tensor, spec,
                compute_dtype=None) -> torch.Tensor:
    """(..., L*F) encoding in ``compute_dtype`` (default: the table's)."""
    return _backend(spec)[0](lowp.rnd(table), positions, spec, compute_dtype)


def init_grid_table(spec, dtype=torch.float32, device=None,
                    generator=None) -> torch.Tensor:
    return _backend(spec)[1](spec, dtype=dtype, device=device, generator=generator)
