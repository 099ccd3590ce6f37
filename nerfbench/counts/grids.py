"""The least work of one grid encode call, forward or backward, from its
spec and its positions: the operations (:func:`grid_ops`) and the bytes,
each input read once and each output written once, the table's entries
counted as the distinct entries the points touch (:func:`touched`).  The
geometry is the frozen plain copy's (``reference/plain/ops``)."""

from __future__ import annotations

import dataclasses

import torch

from nerfbench.counts import peaks


def frozen_spec(spec):
    """The frozen copy's spec of a program's grid spec, field for field."""
    from nerfbench.reference.plain.ops import brickgrid, hashgrid

    cls = {"BrickGridSpec": brickgrid.BrickGridSpec,
           "HashGridSpec": hashgrid.HashGridSpec}[type(spec).__name__]
    return cls(**{f.name: getattr(spec, f.name) for f in dataclasses.fields(cls)})


def is_brick(spec) -> bool:
    return type(spec).__name__ == "BrickGridSpec"


def grid_ops(spec, n: int, backward: bool, pos_grad: bool) -> float:
    """The least operation count of one grid encode call.  Per (point,
    level): the cell math (4 per dimension), then per corner of the 2^D
    (a 4D brick cell: 8 spatial corners x 2 time slices) the weight, D - 1
    multiplies, and F multiply-adds (forward) or F multiplies w*g (the
    backward's table gradient); the position gradient adds per corner the F
    multiply-adds of gdotf and, per dimension, D - 2 multiplies of the
    partial product, one by gdotf and one add."""
    d, f = spec.n_input_dims, spec.n_features_per_level
    lv = getattr(spec, "n_levels_used", spec.n_levels)  # a brick grid's coarse view
    per_corner = (d - 1) + (f if backward else 2 * f)
    if backward and pos_grad:
        per_corner += 2 * f + d * d
    return float(n) * lv * (4 * d + (1 << d) * per_corner)


@torch.no_grad()
def brick_touched(spec, pos) -> int:
    """Table elements that the points read: the distinct (row, corner)
    slots of the 8 live corners (both time slices) per level, times F."""
    from nerfbench.reference.plain.ops.brickgrid import _U32, _brick_rows, _cell, level_constants

    scales, strides, uses_hash = level_constants(spec)
    x = pos.reshape(-1, spec.n_input_dims).float()
    cpa, f = spec.CPA, spec.n_features_per_level
    per_row = spec.row_width // f
    n = 0
    for lvl in range(spec.n_levels_used):
        sc = float(scales[lvl])
        cells = [_cell(x[:, i], sc)[0] for i in range(spec.n_input_dims)]
        offs = [c & (spec.brick_cells - 1) for c in cells[:3]]
        bricks = [(c >> spec.log2_brick_size) & _U32 for c in cells[:3]]
        t_cell = cells[3] & _U32 if spec.has_time else None
        row = _brick_rows(spec, bricks, t_cell, lvl, strides, uses_hash)
        starts = [row * per_row]
        if spec.uses_time_pair:
            starts.append(row * per_row + spec.corners_per_brick)
        elif spec.has_time:
            starts.append(_brick_rows(spec, bricks, (t_cell + 1) & _U32, lvl, strides,
                                      uses_hash) * per_row)
        corner0 = offs[0] + cpa * (offs[1] + cpa * offs[2])
        slots = [s0 + corner0 + dx + cpa * (dy + cpa * dz)
                 for s0 in starts for dz in range(2) for dy in range(2) for dx in range(2)]
        n += int(torch.unique(torch.cat(slots)).numel())
    return n * f


@torch.no_grad()
def hash_touched(spec, pos) -> int:
    """Table elements that the points read: the distinct corner rows per
    level, times F."""
    from nerfbench.reference.plain.ops.hashgrid import _level_geometry, level_constants

    consts = level_constants(spec)
    x = pos.reshape(-1, spec.n_input_dims).float()
    n = sum(int(torch.unique(torch.cat(_level_geometry(x, spec, lvl, consts)[0])).numel())
            for lvl in range(spec.n_levels))
    return n * spec.n_features_per_level


def touched(spec, pos) -> int:
    return brick_touched(spec, pos) if is_brick(spec) else hash_touched(spec, pos)


def least_seconds(spec, n: int, touched_elems: int, backward: bool, pos_grad: bool,
                  table_bytes: int, compute_bytes: int) -> float:
    """The larger of the operations over the fp32 rate and the bytes over
    the HBM rate.  Forward: positions and the touched entries in, the
    encoding (compute dtype) out.  Backward: positions and the encoding's
    cotangent in (and the touched entries, for a position gradient), the
    touched entries' gradient (the table's dtype) out (and the position
    gradient)."""
    d, width = spec.n_input_dims, spec.n_output_dims
    pos_b = n * d * 4
    if backward:
        n_bytes = pos_b + n * width * compute_bytes + touched_elems * table_bytes
        if pos_grad:
            n_bytes += touched_elems * table_bytes + pos_b
    else:
        n_bytes = pos_b + touched_elems * table_bytes + n * width * compute_bytes
    ops = grid_ops(spec, n, backward, pos_grad)
    return max(ops / peaks.FP32_FLOPS, n_bytes / peaks.HBM_BYTES_PER_S)
