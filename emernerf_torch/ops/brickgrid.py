"""Brick-grid encoding (port of ``emernerf_tpu/ops/brickgrid.py``).

A brick stores the (2^b + 1)^3 corner feature vectors of a 2^b x 2^b x 2^b
cell block contiguously in one table row (27 corners for b=1, 125 for b=2):

  cell   = floor(x * scale + 0.5);  frac in [0,1)
  brick  = cell >> b;   o = cell & (2^b - 1)
  row    = spatial_hash(brick) (or linear index when the brick grid fits)
  corner (i,j,k) of the cell lives at brick-local (o+i, o+j, o+k)

Lanes within a level's row are ``corner * F + f`` with the x digit fastest.
4D grids brick space only; time-paired rows (``time_pair=True``) hold the
time corners t and t+1 side by side, ``[:27F]`` and ``[27F:]``.

``brickgrid_encode_ref`` is the plain PyTorch version: it reads only the 8
corners with non-zero trilinear weight (the TPU reference densely weights
the whole row; the zero-weight corners add nothing).  ``brickgrid_encode``
is the differentiable wrapper around the CUDA kernels
(``kernels/csrc/brickgrid.cu``, forward and backward): it takes the plain
versions for CPU tensors only.

The table's storage dtype and the compute dtype are separate:
``brickgrid_encode(table, positions, spec, compute_dtype)`` takes the fp32
parameter itself and computes as ``brickgrid_encode(table.to(compute_dtype),
...)`` would, bit for bit, without that copy: the kernels round each
value they read to the compute dtype in registers, and the autograd
Function saves the parameter, not a cast of it.  The encoding comes out in
the compute dtype.  The backward accumulates in fp32 and returns the table
gradient in the table's dtype, rounded once to the compute dtype first
(``float(bf16(sum))`` for an fp32 table of a bf16 computation, as the
reference casts each level and autograd of the cast would return it), and
the position gradient only where the positions need one (the flow-warped
queries).  The plain versions cast first.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import numpy as np
import torch

from emernerf_torch import kernels

# Instant-NGP spatial-hash primes (prime_0 = 1, as in tiny-cuda-nn)
_PRIMES = (1, 2654435761, 805459861, 3674653429)
_U32 = 0xFFFFFFFF
MAX_LEVELS = 32


@dataclass(frozen=True)
class BrickGridSpec:
    """Static description of a brick-grid encoder.

    Level scales and resolutions follow Instant-NGP's geometric growth over
    cells.  ``log2_bricks`` sizes each level's table slice."""

    n_input_dims: int = 3
    n_levels: int = 16
    base_resolution: int = 16
    max_resolution: int = 2048
    log2_bricks: int = 16
    n_features_per_level: int = 2
    log2_brick_size: int = 1
    time_pair: bool = False

    @property
    def brick_cells(self) -> int:
        return 1 << self.log2_brick_size

    @property
    def CPA(self) -> int:
        """Corners per axis inside one brick."""
        return self.brick_cells + 1

    @property
    def spatial_dims(self) -> int:
        return min(self.n_input_dims, 3)

    @property
    def has_time(self) -> bool:
        return self.n_input_dims == 4

    @property
    def corners_per_brick(self) -> int:
        return self.CPA ** self.spatial_dims

    @property
    def uses_time_pair(self) -> bool:
        return self.has_time and self.time_pair

    @property
    def row_width(self) -> int:
        w = self.corners_per_brick * self.n_features_per_level
        return 2 * w if self.uses_time_pair else w

    @property
    def bricks_per_level(self) -> int:
        return 1 << self.log2_bricks

    @property
    def table_shape(self) -> Tuple[int, int]:
        return (self.n_levels * self.bricks_per_level, self.row_width)

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @cached_property
    def growth_factor(self) -> float:
        if self.n_levels <= 1:
            return 1.0
        return math.exp(
            (math.log(self.max_resolution) - math.log(self.base_resolution))
            / (self.n_levels - 1)
        )

    @cached_property
    def level_scales(self) -> np.ndarray:
        log2g = math.log2(self.growth_factor)
        return np.asarray(
            [math.exp2(lv * log2g) * self.base_resolution - 1.0
             for lv in range(self.n_levels)],
            dtype=np.float64,
        )

    @cached_property
    def level_resolutions(self) -> np.ndarray:
        """Cell-grid resolutions (corners per axis)."""
        return np.asarray(
            [int(math.ceil(s)) + 1 for s in self.level_scales], dtype=np.int64
        )

    @cached_property
    def brick_resolutions(self) -> np.ndarray:
        """Bricks per axis: cell coord c -> brick coord c >> log2_brick_size."""
        return np.asarray(
            [((int(r) - 1) >> self.log2_brick_size) + 1
             for r in self.level_resolutions],
            dtype=np.int64,
        )

    @cached_property
    def level_uses_hash(self) -> np.ndarray:
        """True when the (spatial [* time]) brick grid exceeds the table."""
        out = []
        for li, r in enumerate(self.brick_resolutions):
            cells = int(r) ** self.spatial_dims
            if self.has_time:
                cells *= int(self.level_resolutions[li])
            out.append(cells > self.bricks_per_level)
        return np.asarray(out, dtype=bool)


def init_brickgrid_table(spec: BrickGridSpec, dtype=torch.float32,
                         device=None, generator=None):
    """U(-1e-4, 1e-4), matching tcnn's hash-table init."""
    t = torch.empty(spec.table_shape, dtype=torch.float32, device=device)
    t.uniform_(-1e-4, 1e-4, generator=generator)
    return t.to(dtype)


def level_constants(spec: BrickGridSpec):
    """(scales float32 (L,), strides uint32 (L, D_s [+1]), uses_hash (L,))."""
    d = spec.spatial_dims
    scales = np.asarray(spec.level_scales, dtype=np.float32)
    strides = []
    for r in spec.brick_resolutions:
        s = [(int(r) ** i) & _U32 for i in range(d)]
        if spec.has_time:
            s.append((int(r) ** d) & _U32)  # time stride
        strides.append(s)
    return scales, np.asarray(strides, dtype=np.uint32), np.asarray(
        spec.level_uses_hash)


def _brick_rows(spec, bricks, t_cell, lvl, strides, uses_hash):
    """Level-local rows from int64 brick coords, with uint32 wraparound."""
    if uses_hash[lvl]:
        r = (bricks[0] * _PRIMES[0]) & _U32
        for i in range(1, spec.spatial_dims):
            r = r ^ ((bricks[i] * _PRIMES[i]) & _U32)
        if t_cell is not None:
            r = r ^ ((t_cell * _PRIMES[3]) & _U32)
    else:
        r = (bricks[0] * int(strides[lvl][0])) & _U32
        for i in range(1, spec.spatial_dims):
            r = (r + bricks[i] * int(strides[lvl][i])) & _U32
        if t_cell is not None:
            r = (r + t_cell * int(strides[lvl][spec.spatial_dims])) & _U32
    return r & (spec.bricks_per_level - 1)


def _cell(x: torch.Tensor, scale: float):
    """floor(x * scale + 0.5) and the fraction, each op rounded separately."""
    pos = x * scale
    pos = pos + 0.5
    cell = torch.floor(pos)
    return cell.to(torch.int64), pos - cell


def _level_geometry(x: torch.Tensor, spec: BrickGridSpec, lvl: int, consts):
    """Per level: the corner offsets inside the brick and the fractions per
    axis (3 each, (N,)), the time fraction (or None), and the flat element
    offsets of the row(s) that hold the point's corners: base0, and base1
    for the t+1 time corner (None without time)."""
    scales, strides, uses_hash = consts
    b, width = spec.bricks_per_level, spec.row_width
    sc = float(scales[lvl])
    offs, fracs, bricks = [], [], []
    for i in range(3):
        ci, fr = _cell(x[:, i], sc)
        offs.append(ci & (spec.brick_cells - 1))
        bricks.append((ci >> spec.log2_brick_size) & _U32)
        fracs.append(fr)
    t_cell = t_frac = None
    if spec.has_time:
        ti, t_frac = _cell(x[:, 3], sc)
        t_cell = ti & _U32
    base0 = (lvl * b + _brick_rows(spec, bricks, t_cell, lvl, strides, uses_hash)) * width
    base1 = None
    if spec.uses_time_pair:
        base1 = base0 + spec.corners_per_brick * spec.n_features_per_level
    elif spec.has_time:
        base1 = (lvl * b + _brick_rows(spec, bricks, (t_cell + 1) & _U32, lvl, strides,
                                       uses_hash)) * width
    return offs, fracs, t_frac, base0, base1


def _corners(spec: BrickGridSpec, offs, fracs):
    """The 8 live corners in the kernels' order (dz, dy, dx; x fastest):
    (dx, dy, dz, wx, wy, wz, w = (wx * wy) * wz, lane offset of the corner's
    first feature in the row)."""
    cpa, f = spec.CPA, spec.n_features_per_level
    for dz in range(2):
        wz = fracs[2] if dz else 1.0 - fracs[2]
        for dy in range(2):
            wy = fracs[1] if dy else 1.0 - fracs[1]
            for dx in range(2):
                wx = fracs[0] if dx else 1.0 - fracs[0]
                corner = (offs[0] + dx) + cpa * ((offs[1] + dy) + cpa * (offs[2] + dz))
                yield dx, dy, dz, wx, wy, wz, (wx * wy) * wz, corner * f


def brickgrid_encode_ref(table: torch.Tensor, positions: torch.Tensor,
                         spec: BrickGridSpec, compute_dtype=None) -> torch.Tensor:
    """Plain version: positions (..., D) in [0,1] -> (..., L*F) features in
    the compute dtype (default: the table's), accumulated in fp32 over the
    8 live corners of ``table.to(compute_dtype)``."""
    if compute_dtype is not None:
        table = table.to(compute_dtype)
    d, f = spec.n_input_dims, spec.n_features_per_level
    batch = positions.shape[:-1]
    x = positions.reshape(-1, d).float()
    consts = level_constants(spec)
    flat = table.reshape(-1)
    lanes = torch.arange(f, device=table.device)
    outs = []
    for lvl in range(spec.n_levels):
        offs, fracs, t_frac, base0, base1 = _level_geometry(x, spec, lvl, consts)
        acc0 = torch.zeros(x.shape[0], f, device=x.device)
        acc1 = torch.zeros_like(acc0) if base1 is not None else None
        for *_, w, lane in _corners(spec, offs, fracs):
            lane = lane[:, None] + lanes
            acc0 = acc0 + w[:, None] * flat[base0[:, None] + lane].float()
            if acc1 is not None:
                acc1 = acc1 + w[:, None] * flat[base1[:, None] + lane].float()
        if acc1 is not None:
            tw = t_frac[:, None]
            acc0 = acc0 * (1.0 - tw) + acc1 * tw
        outs.append(acc0)
    out = torch.cat(outs, dim=-1).to(table.dtype)
    return out.reshape(*batch, spec.n_output_dims)


class _BrickParams(ctypes.Structure):
    """Mirror of ``BrickParams`` in kernels/csrc/brickgrid.cu."""

    _fields_ = [
        ("n_levels", ctypes.c_int),
        ("n_features", ctypes.c_int),
        ("n_dims", ctypes.c_int),
        ("log2_brick_size", ctypes.c_int),
        ("time_pair", ctypes.c_int),
        ("row_width", ctypes.c_int),
        ("bricks_per_level", ctypes.c_longlong),
        ("scales", ctypes.c_float * MAX_LEVELS),
        ("strides", ctypes.c_uint * (MAX_LEVELS * 4)),
        ("uses_hash", ctypes.c_int * MAX_LEVELS),
    ]


def _kernel_params(spec: BrickGridSpec) -> _BrickParams:
    scales, strides, uses_hash = level_constants(spec)
    p = _BrickParams()
    p.n_levels = spec.n_levels
    p.n_features = spec.n_features_per_level
    p.n_dims = spec.n_input_dims
    p.log2_brick_size = spec.log2_brick_size
    p.time_pair = int(spec.uses_time_pair)
    p.row_width = spec.row_width
    p.bricks_per_level = spec.bricks_per_level
    for li in range(spec.n_levels):
        p.scales[li] = float(scales[li])
        p.uses_hash[li] = int(uses_hash[li])
        for a, s in enumerate(strides[li]):
            p.strides[4 * li + a] = int(s)
    return p


_DTYPES = (torch.float32, torch.bfloat16)


def _check_encode_args(name, table, positions, spec, compute_dtype):
    if tuple(table.shape) != spec.table_shape:
        raise ValueError(f"{name}: table {tuple(table.shape)} != {spec.table_shape}")
    if table.dtype not in _DTYPES or compute_dtype not in _DTYPES:
        raise ValueError(f"{name}: table dtype {table.dtype}, compute dtype {compute_dtype}")
    if positions.shape[-1] != spec.n_input_dims or positions.dtype != torch.float32:
        raise ValueError(f"{name}: positions must be (..., {spec.n_input_dims}) float32")
    if spec.n_features_per_level > 8 or spec.n_levels > MAX_LEVELS:
        raise ValueError(f"{name}: F <= 8 and L <= {MAX_LEVELS} supported")


def _require_aligned_table(name, table):
    if table.data_ptr() % 16:
        raise ValueError(f"{name}: the table must be 16-byte aligned (vector loads)")


def _is_bf16(dtype) -> int:
    return int(dtype == torch.bfloat16)


def _encode_forward(table, positions, spec, compute_dtype):
    """The K1 forward: plain version for CPU tensors, the kernel for CUDA."""
    name = "brickgrid_encode"
    if kernels.dispatch_device(name, table) == "cpu":
        return brickgrid_encode_ref(table, positions, spec, compute_dtype)
    kernels.require_cuda_inputs(name, table, positions)
    _require_aligned_table(name, table)
    lib = kernels.load()
    batch = positions.shape[:-1]
    n = positions.numel() // spec.n_input_dims
    out = torch.empty((n, spec.n_output_dims), dtype=compute_dtype,
                      device=table.device)
    if n == 0:
        return out.reshape(*batch, spec.n_output_dims)
    params = _kernel_params(spec)
    err = lib.emt_brickgrid_encode(
        table.data_ptr(), _is_bf16(table.dtype), _is_bf16(compute_dtype),
        positions.data_ptr(), out.data_ptr(), n, ctypes.addressof(params),
        kernels.stream_ptr(table.device),
    )
    kernels.check(err, name)
    brickgrid_encode.launches += 1
    return out.reshape(*batch, spec.n_output_dims)


def brickgrid_encode_bwd_ref(table, positions, grad_out, spec: BrickGridSpec,
                             needs_pos_grad: bool, compute_dtype=None):
    """Plain version of :func:`brickgrid_encode_bwd`, in the kernel's order
    of operations, on ``table.to(compute_dtype)``: (d table in the table's
    dtype, d positions (..., D) float32 or None).

    The table gradient adds w * tw * g of every live corner and time slice
    into a zeroed fp32 buffer, rounds it once to the compute dtype and
    returns it in the table's.  The position gradient
    re-reads the corners: per level, in corner order,
      acc_a += dW/dfrac_a * gl  (gl = the time-lerped feats . g),
      acc_t += W * (feats1 . g - feats0 . g),
    then d_pos = d_pos + acc * scale over the levels in order.  Every
    product and sum is one fp32 operation, so the kernel's position
    gradient equals this one bit for bit."""
    stored = table.dtype
    if compute_dtype is not None:
        table = table.to(compute_dtype)
    d, f = spec.n_input_dims, spec.n_features_per_level
    batch = positions.shape[:-1]
    x = positions.reshape(-1, d).float()
    n = x.shape[0]
    g = grad_out.reshape(n, spec.n_levels, f).to(table.dtype).float()
    consts = level_constants(spec)
    flat = table.reshape(-1)
    lanes = torch.arange(f, device=table.device)
    d_flat = torch.zeros(flat.numel(), dtype=torch.float32, device=x.device)
    d_pos = [torch.zeros(n, device=x.device) for _ in range(d)] if needs_pos_grad else None
    for lvl in range(spec.n_levels):
        offs, fracs, t_frac, base0, base1 = _level_geometry(x, spec, lvl, consts)
        g_l = g[:, lvl]  # (N, F)
        tw0 = None if base1 is None else 1.0 - t_frac
        acc = [torch.zeros(n, device=x.device) for _ in range(d)]
        for dx, dy, dz, wx, wy, wz, w, lane in _corners(spec, offs, fracs):
            idx0 = base0[:, None] + (lane[:, None] + lanes)
            w0 = w if tw0 is None else w * tw0
            d_flat.index_add_(0, idx0.reshape(-1), (w0[:, None] * g_l).reshape(-1))
            if base1 is not None:
                idx1 = base1[:, None] + (lane[:, None] + lanes)
                d_flat.index_add_(0, idx1.reshape(-1), ((w * t_frac)[:, None] * g_l).reshape(-1))
            if not needs_pos_grad:
                continue
            feats = flat[idx0].float()
            dot0 = torch.zeros(n, device=x.device)
            for fi in range(f):
                dot0 = dot0 + g_l[:, fi] * feats[:, fi]
            gl = dot0
            if base1 is not None:
                feats = flat[idx1].float()
                dot1 = torch.zeros(n, device=x.device)
                for fi in range(f):
                    dot1 = dot1 + g_l[:, fi] * feats[:, fi]
                gl = dot0 * tw0 + dot1 * t_frac
                acc[3] = acc[3] + w * (dot1 - dot0)
            # dW/dfrac_a: the axis' own weight becomes +-1
            for a, (bit, p) in enumerate(((dx, wy * wz), (dy, wx * wz), (dz, wx * wy))):
                acc[a] = acc[a] + (p if bit else -p) * gl
        if needs_pos_grad:
            sc = float(consts[0][lvl])
            d_pos = [dp + acc_a * sc for dp, acc_a in zip(d_pos, acc)]
    d_table = d_flat.reshape(spec.table_shape).to(table.dtype).to(stored)
    if d_pos is None:
        return d_table, None
    return d_table, torch.stack(d_pos, -1).reshape(*batch, d)


def brickgrid_encode_bwd(table: torch.Tensor, positions: torch.Tensor,
                         grad_out: torch.Tensor, spec: BrickGridSpec,
                         needs_pos_grad: bool, compute_dtype=None):
    """K1 backward: (d table in the table's dtype, d positions or None).

    grad_out is the cotangent of the (..., L*F) encoding; ``compute_dtype``
    (default: the table's) the forward's.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    name = "brickgrid_encode_bwd"
    if kernels.dispatch_device(name, table) == "cpu":
        return brickgrid_encode_bwd_ref(table, positions, grad_out, spec, needs_pos_grad,
                                        compute_dtype)
    compute_dtype = compute_dtype or table.dtype
    grad_out = grad_out.to(compute_dtype).contiguous()
    if grad_out.data_ptr() % 16:  # the kernel loads a point's F values at once
        grad_out = grad_out.clone()
    kernels.require_cuda_inputs(name, table, positions, grad_out)
    _require_aligned_table(name, table)
    lib = kernels.load()
    n = positions.numel() // spec.n_input_dims
    d_table = torch.zeros(spec.table_shape, dtype=torch.float32, device=table.device)
    d_pos = torch.empty_like(positions) if needs_pos_grad else None
    if n > 0:
        params = _kernel_params(spec)
        err = lib.emt_brickgrid_backward(
            table.data_ptr(), _is_bf16(table.dtype), _is_bf16(compute_dtype),
            positions.data_ptr(), grad_out.data_ptr(), d_table.data_ptr(),
            None if d_pos is None else d_pos.data_ptr(), n,
            ctypes.addressof(params), kernels.stream_ptr(table.device),
        )
        kernels.check(err, name)
        brickgrid_encode_bwd.launches += 1
    # an fp32 table's gradient is the buffer itself, which the kernels round
    # to bf16 precision in place for a bf16 computation
    return d_table.to(table.dtype), d_pos


brickgrid_encode_bwd.launches = 0


class _BrickGridEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, positions, spec, compute_dtype):
        ctx.spec, ctx.compute_dtype = spec, compute_dtype
        ctx.save_for_backward(table, positions)  # the table as stored: no cast is kept
        return _encode_forward(table, positions, spec, compute_dtype)

    @staticmethod
    def backward(ctx, grad_out):
        table, positions = ctx.saved_tensors
        d_table, d_pos = brickgrid_encode_bwd(table, positions, grad_out, ctx.spec,
                                              ctx.needs_input_grad[1], ctx.compute_dtype)
        return (d_table if ctx.needs_input_grad[0] else None), d_pos, None, None


def brickgrid_encode(table: torch.Tensor, positions: torch.Tensor,
                     spec: BrickGridSpec, compute_dtype=None) -> torch.Tensor:
    """Encode positions (..., D) in [0,1] -> (..., L*F) in the compute dtype
    (default: the table's), as ``table.to(compute_dtype)`` would encode them.

    Differentiable in the table and the positions.  CPU tensors take the
    plain versions; CUDA tensors launch the K1 kernels (and raise if they
    cannot be built or launched)."""
    compute_dtype = compute_dtype or table.dtype
    _check_encode_args("brickgrid_encode", table, positions, spec, compute_dtype)
    return _BrickGridEncode.apply(table, positions, spec, compute_dtype)


brickgrid_encode.launches = 0
