"""Grid-encoder dispatch (port of ``emernerf_tpu/ops/grid.py``).

Only the brick grid is ported so far; the exact hash grid follows in a later
PR.  The MX grid was rejected on quality and is not ported.
"""

from __future__ import annotations

import torch

from emernerf_torch.ops.brickgrid import (
    BrickGridSpec,
    brickgrid_encode,
    init_brickgrid_table,
)


def _require_brick(spec) -> None:
    if not isinstance(spec, BrickGridSpec):
        raise NotImplementedError(
            f"{type(spec).__name__}: only the brick grid is ported; the "
            "exact hash grid is ported in a later PR")


def grid_encode(table: torch.Tensor, positions: torch.Tensor, spec) -> torch.Tensor:
    _require_brick(spec)
    return brickgrid_encode(table, positions, spec)


def init_grid_table(spec, dtype=torch.float32, device=None,
                    generator=None) -> torch.Tensor:
    _require_brick(spec)
    return init_brickgrid_table(spec, dtype=dtype, device=device, generator=generator)
