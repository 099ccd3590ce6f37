"""Grid-encoder dispatch on the spec type (port of ``emernerf_tpu/ops/grid.py``).

``BrickGridSpec`` -> the brick grid (K1), ``HashGridSpec`` -> the exact
tiny-cuda-nn hash grid (K4).  The MX grid was rejected on quality and is not
ported.
"""

from __future__ import annotations

import torch

from emernerf_torch.ops.brickgrid import (
    BrickGridSpec,
    brickgrid_encode,
    init_brickgrid_table,
)
from emernerf_torch.ops.hashgrid import HashGridSpec, hashgrid_encode, init_hashgrid_table

_BACKENDS = {
    BrickGridSpec: (brickgrid_encode, init_brickgrid_table),
    HashGridSpec: (hashgrid_encode, init_hashgrid_table),
}


def _backend(spec):
    try:
        return _BACKENDS[type(spec)]
    except KeyError:
        raise NotImplementedError(
            f"{type(spec).__name__}: only the brick and hash grids are ported") from None


def grid_encode(table: torch.Tensor, positions: torch.Tensor, spec) -> torch.Tensor:
    return _backend(spec)[0](table, positions, spec)


def init_grid_table(spec, dtype=torch.float32, device=None,
                    generator=None) -> torch.Tensor:
    return _backend(spec)[1](spec, dtype=dtype, device=device, generator=generator)
