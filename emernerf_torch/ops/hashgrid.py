"""Multi-resolution hash-grid encoding, the exact tiny-cuda-nn layout (port
of ``emernerf_tpu/ops/hashgrid.py``, kernel K4).

Per level l (Instant-NGP): ``scale_l = 2^(l log2 growth) * base - 1``,
resolution ``R_l = ceil(scale_l) + 1``; ``pos = x * scale_l + 0.5``, the
corner ``floor(pos)`` and d-linear weights over the 2^D corners; a corner's
row is its linear index when ``R_l^D`` fits the level's ``T`` entries, else
the spatial hash ``xor_d(corner_d * prime_d)``, both in uint32 arithmetic
and masked to ``T - 1``.  Every level owns a full ``T = 2^log2_hashmap_size``
slice of one feature-major ``(F, L*T)`` table, the JAX package's layout.

The level constants are the JAX package's exactly: float64 scales cast to
float32 for the cell math, resolutions from the float64 scales, and
``R^D > T`` in Python ints.  Corner coordinates may reach ``R`` (a point at
x = 1 on a level whose scale is an integer); that index is reproduced, not
clamped.

``hashgrid_encode_plain`` and ``hashgrid_encode_bwd_plain`` follow the
custom-VJP forward and backward of the JAX package (not its autodiff
reference): weights as products in dimension order, corner sums in corner
order, the table gradient summed in fp32 and cast once to the table's
dtype, position gradients through the signed partial products times the
level scale.  They accumulate in fp32 and round once; the JAX forward
accumulates in the table's dtype (ROADMAP queue 3, "bf16 accumulation").
``hashgrid_encode`` is the differentiable wrapper around the CUDA kernels
(``kernels/csrc/hashgrid.cu``): plain versions for CPU tensors only.  It
saves only the table and the positions and recomputes the rest in the
backward, as the JAX custom VJP does.  On the card the kernels read a
features-minor ``(L*T, F)`` copy of the table (:func:`features_minor`, made
once per forward and saved in place of the table); the parameter, its
gradient and everything outside the wrapper keep ``(F, L*T)``.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from functools import cache, cached_property
from typing import List, Tuple

import numpy as np
import torch

from emernerf_torch import kernels

# Instant-NGP spatial-hash primes (prime_0 = 1, as in tiny-cuda-nn)
_PRIMES = (1, 2654435761, 805459861, 3674653429)
_U32 = 0xFFFFFFFF
MAX_LEVELS = 32


@dataclass(frozen=True)
class HashGridSpec:
    """Static description of a hash-grid encoder (tiny-cuda-nn's
    HashGrid defaults)."""

    n_input_dims: int = 3
    n_levels: int = 16
    base_resolution: int = 16
    max_resolution: int = 2048
    log2_hashmap_size: int = 19
    n_features_per_level: int = 2

    @property
    def growth_factor(self) -> float:
        if self.n_levels <= 1:
            return 1.0
        return math.exp(
            (math.log(self.max_resolution) - math.log(self.base_resolution))
            / (self.n_levels - 1))

    @property
    def table_entries_per_level(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def table_shape(self) -> Tuple[int, int]:
        """Feature-major (F, L*T)."""
        return (self.n_features_per_level,
                self.n_levels * self.table_entries_per_level)

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def num_parameters(self) -> int:
        return self.table_shape[0] * self.table_shape[1]

    @cached_property
    def level_scales(self) -> np.ndarray:
        log2g = math.log2(self.growth_factor)
        return np.asarray([math.exp2(lv * log2g) * self.base_resolution - 1.0
                           for lv in range(self.n_levels)], dtype=np.float64)

    @cached_property
    def level_resolutions(self) -> np.ndarray:
        return np.asarray([int(math.ceil(s)) + 1 for s in self.level_scales],
                          dtype=np.int64)

    @cached_property
    def level_uses_hash(self) -> np.ndarray:
        """True where R^D exceeds the level's table (exact Python ints)."""
        t = self.table_entries_per_level
        return np.asarray([int(r) ** self.n_input_dims > t
                           for r in self.level_resolutions], dtype=bool)


def init_hashgrid_table(spec: HashGridSpec, dtype=torch.float32, device=None,
                        generator=None):
    """U(-1e-4, 1e-4), tiny-cuda-nn's hash-table init."""
    t = torch.empty(spec.table_shape, dtype=torch.float32, device=device)
    t.uniform_(-1e-4, 1e-4, generator=generator)
    return t.to(dtype)


def level_constants(spec: HashGridSpec):
    """(scales float32 (L,), linear strides uint32 (L, D), uses_hash (L,))."""
    d = spec.n_input_dims
    scales = np.asarray(spec.level_scales, dtype=np.float32)
    strides = np.asarray([[(int(r) ** i) & _U32 for i in range(d)]
                          for r in spec.level_resolutions], dtype=np.uint32)
    return scales, strides, np.asarray(spec.level_uses_hash)


def _corner_bits(d: int) -> List[Tuple[int, ...]]:
    """Corner c has bit (c >> i) & 1 along dimension i."""
    return [tuple((c >> i) & 1 for i in range(d)) for c in range(1 << d)]


def _level_geometry(x: torch.Tensor, spec: HashGridSpec, lvl: int, consts):
    """Rows (one (N,) int64 tensor per corner, local to the level's slice)
    and fractions (D, N) of points x (N, D) on level ``lvl``."""
    scales, strides, uses_hash = consts
    pos = x.T * float(scales[lvl])
    pos = pos + 0.5  # rounded separately: no fused multiply-add
    cell = torch.floor(pos)
    frac = pos - cell
    grid = cell.to(torch.int64)
    # int64 products and sums: their low 32 bits are the uint32 arithmetic's
    # (mask < 2^32), and |coord * prime| < 2^45 cannot overflow
    mask = spec.table_entries_per_level - 1
    rows = []
    for bits in _corner_bits(spec.n_input_dims):
        coords = [grid[i] + b for i, b in enumerate(bits)]
        if uses_hash[lvl]:
            r = coords[0] * _PRIMES[0]
            for i in range(1, len(coords)):
                r = r ^ (coords[i] * _PRIMES[i])
        else:
            r = coords[0] * int(strides[lvl][0])
            for i in range(1, len(coords)):
                r = r + coords[i] * int(strides[lvl][i])
        rows.append(r & mask)
    return rows, frac


def _terms(frac: torch.Tensor, bits, skip: int = -1):
    """The per-dimension weight factors of one corner, in dimension order."""
    return [frac[i] if b else 1.0 - frac[i] for i, b in enumerate(bits) if i != skip]


def _product(terms):
    w = terms[0]
    for t in terms[1:]:
        w = w * t
    return w


def hashgrid_encode_plain(table: torch.Tensor, positions: torch.Tensor,
                          spec: HashGridSpec) -> torch.Tensor:
    """Plain version of K4's forward: positions (..., D) in [0,1] -> (...,
    L*F) in the table's dtype, accumulated in fp32 over the 2^D corners."""
    d, f, t = spec.n_input_dims, spec.n_features_per_level, spec.table_entries_per_level
    batch = positions.shape[:-1]
    x = positions.reshape(-1, d).float()
    n = x.shape[0]
    consts = level_constants(spec)
    out = torch.empty((n, spec.n_levels, f), dtype=torch.float32, device=x.device)
    for lvl in range(spec.n_levels):
        rows, frac = _level_geometry(x, spec, lvl, consts)
        level = table[:, lvl * t:(lvl + 1) * t]
        acc = torch.zeros((f, n), dtype=torch.float32, device=x.device)
        for bits, r in zip(_corner_bits(d), rows):
            acc = acc + _product(_terms(frac, bits)) * level[:, r].float()
        out[:, lvl] = acc.T
    return out.reshape(*batch, spec.n_output_dims).to(table.dtype)


def hashgrid_encode_bwd_plain(table: torch.Tensor, positions: torch.Tensor,
                              grad_out: torch.Tensor, spec: HashGridSpec,
                              needs_pos_grad: bool):
    """Plain version of K4's backward: (d table in the table's dtype, d
    positions (..., D) float32 or None).  The table gradient sums w * g into
    a zeroed fp32 (F, L*T) buffer, cast once; the position gradient sums,
    per level, (feats . g) times the signed partial weight products, times
    the level's scale."""
    d, f, t = spec.n_input_dims, spec.n_features_per_level, spec.table_entries_per_level
    batch = positions.shape[:-1]
    x = positions.reshape(-1, d).float()
    n = x.shape[0]
    g = grad_out.reshape(n, spec.n_levels, f).float()
    consts = level_constants(spec)
    d_table = torch.zeros(spec.table_shape, dtype=torch.float32, device=x.device)
    d_pos = torch.zeros((d, n), dtype=torch.float32, device=x.device) if needs_pos_grad else None
    for lvl in range(spec.n_levels):
        rows, frac = _level_geometry(x, spec, lvl, consts)
        g_l = g[:, lvl].T  # (F, N)
        level = table[:, lvl * t:(lvl + 1) * t]
        acc = [None] * d
        for bits, r in zip(_corner_bits(d), rows):
            d_table.index_add_(1, r + lvl * t, _product(_terms(frac, bits)) * g_l)
            if not needs_pos_grad:
                continue
            feats = level[:, r].float()
            gdotf = torch.zeros_like(g_l[0])
            for fi in range(f):
                gdotf = gdotf + feats[fi] * g_l[fi]
            for i in range(d):
                others = _terms(frac, bits, skip=i)
                dw = _product(others) if others else torch.ones_like(frac[i])
                contrib = gdotf * (dw if bits[i] else -dw)
                acc[i] = contrib if acc[i] is None else acc[i] + contrib
        if needs_pos_grad:
            scale = float(consts[0][lvl])
            for i in range(d):
                d_pos[i] = d_pos[i] + acc[i] * scale
    d_pos = None if d_pos is None else d_pos.T.reshape(*batch, d)
    return d_table.to(table.dtype), d_pos


class _HashParams(ctypes.Structure):
    """Mirror of ``HashParams`` in kernels/csrc/hashgrid.cu."""

    _fields_ = [
        ("n_levels", ctypes.c_int),
        ("n_features", ctypes.c_int),
        ("n_dims", ctypes.c_int),
        ("log2_table", ctypes.c_int),
        ("scales", ctypes.c_float * MAX_LEVELS),
        ("strides", ctypes.c_uint * (MAX_LEVELS * 4)),
        ("uses_hash", ctypes.c_int * MAX_LEVELS),
    ]


@cache
def _kernel_params(spec: HashGridSpec) -> _HashParams:
    """The kernels' level constants, built once per spec (host time before
    each launch; the struct is read, never written, by the callers)."""
    scales, strides, uses_hash = level_constants(spec)
    p = _HashParams()
    p.n_levels = spec.n_levels
    p.n_features = spec.n_features_per_level
    p.n_dims = spec.n_input_dims
    p.log2_table = spec.log2_hashmap_size
    for li in range(spec.n_levels):
        p.scales[li] = float(scales[li])
        p.uses_hash[li] = int(uses_hash[li])
        for a, s in enumerate(strides[li]):
            p.strides[4 * li + a] = int(s)
    return p


def _check_encode_args(name, table, positions, spec):
    if tuple(table.shape) != spec.table_shape:
        raise ValueError(f"{name}: table {tuple(table.shape)} != {spec.table_shape}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: table dtype {table.dtype}")
    if positions.shape[-1] != spec.n_input_dims or positions.dtype != torch.float32:
        raise ValueError(f"{name}: positions must be (..., {spec.n_input_dims}) float32")
    if spec.n_features_per_level not in (1, 2, 4) or spec.n_levels > MAX_LEVELS:
        raise ValueError(f"{name}: F in (1, 2, 4) and L <= {MAX_LEVELS} supported")


def _cuda_params(name, spec, *tensors):
    kernels.require_cuda_inputs(name, *tensors)
    if spec.n_input_dims not in (3, 4):
        raise ValueError(f"{name}: the kernel takes 3D or 4D positions")
    return _kernel_params(spec)


def features_minor_plain(table: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`features_minor`."""
    return table.t().contiguous()


def features_minor(table: torch.Tensor) -> torch.Tensor:
    """The (L*T, F) features-minor copy of a feature-major (F, L*T) table,
    in its dtype, that K4's kernels read: a corner's F features in one
    vector load.  An F = 1 table is both layouts at once: a view, no copy.
    CPU tensors take the plain version; CUDA tensors launch
    ``features_minor_kernel`` (kernels/csrc/hashgrid.cu)."""
    name = "features_minor"
    if table.shape[0] == 1:
        return table.reshape(-1, 1)
    if kernels.dispatch_device(name, table) == "cpu":
        return features_minor_plain(table)
    kernels.require_cuda_inputs(name, table)
    if table.shape[0] not in (2, 4):
        raise ValueError(f"{name}: F in (1, 2, 4) supported")
    f, rows = table.shape
    out = torch.empty((rows, f), dtype=table.dtype, device=table.device)
    err = kernels.load().emt_hashgrid_features_minor(
        table.data_ptr(), table.element_size(), out.data_ptr(), rows, f,
        kernels.stream_ptr(table.device))
    kernels.check(err, name)
    features_minor.launches += 1
    return out


features_minor.launches = 0


def _launch_forward(table_fm, positions, spec):
    """K4 forward on the card from the features-minor table."""
    name = "hashgrid_encode"
    params = _cuda_params(name, spec, table_fm, positions)
    lib = kernels.load()
    batch = positions.shape[:-1]
    n = positions.numel() // spec.n_input_dims
    out = torch.empty((n, spec.n_output_dims), dtype=table_fm.dtype, device=table_fm.device)
    if n > 0:
        err = lib.emt_hashgrid_encode(
            table_fm.data_ptr(), int(table_fm.dtype == torch.bfloat16), positions.data_ptr(),
            out.data_ptr(), n, ctypes.addressof(params), kernels.stream_ptr(table_fm.device))
        kernels.check(err, name)
        hashgrid_encode.launches += 1
    return out.reshape(*batch, spec.n_output_dims)


def _launch_backward(table_fm, positions, grad_out, spec, needs_pos_grad):
    """K4 backward on the card from the features-minor table: (d table
    (F, L*T) in the table's dtype, d positions or None)."""
    name = "hashgrid_encode_bwd"
    dtype, device = table_fm.dtype, table_fm.device
    grad_out = grad_out.to(dtype).contiguous()
    if grad_out.data_ptr() % 16:  # the kernel loads a point's F values at once
        grad_out = grad_out.clone()
    params = _cuda_params(name, spec, table_fm, positions, grad_out)
    lib = kernels.load()
    n = positions.numel() // spec.n_input_dims
    if n == 0:
        return (torch.zeros(spec.table_shape, dtype=dtype, device=device),
                torch.zeros_like(positions) if needs_pos_grad else None)
    f, rows = spec.table_shape
    # the features-minor fp32 sum, transposed and cast into d_table
    scratch = torch.zeros((rows, f), dtype=torch.float32, device=device)
    d_table = torch.empty(spec.table_shape, dtype=dtype, device=device)
    d_pos = torch.empty_like(positions) if needs_pos_grad else None
    err = lib.emt_hashgrid_backward(
        table_fm.data_ptr(), int(dtype == torch.bfloat16), positions.data_ptr(),
        grad_out.data_ptr(), scratch.data_ptr(), d_table.data_ptr(),
        None if d_pos is None else d_pos.data_ptr(), n, ctypes.addressof(params),
        kernels.stream_ptr(device))
    kernels.check(err, name)
    hashgrid_encode_bwd.launches += 1
    return d_table, d_pos


def hashgrid_encode_bwd(table: torch.Tensor, positions: torch.Tensor,
                        grad_out: torch.Tensor, spec: HashGridSpec,
                        needs_pos_grad: bool):
    """K4 backward: (d table in the table's dtype, d positions or None).

    grad_out is the cotangent of the (..., L*F) encoding.  CPU tensors take
    the plain version; CUDA tensors launch the kernel on the table's
    features-minor copy."""
    if kernels.dispatch_device("hashgrid_encode_bwd", table) == "cpu":
        return hashgrid_encode_bwd_plain(table, positions, grad_out, spec, needs_pos_grad)
    return _launch_backward(features_minor(table), positions, grad_out, spec, needs_pos_grad)


hashgrid_encode_bwd.launches = 0


class _HashGridEncode(torch.autograd.Function):
    """On the card the forward reads the table's features-minor copy and
    saves it, in place of the table, for the backward's position-gradient
    re-read."""

    @staticmethod
    def forward(ctx, table, positions, spec):
        ctx.spec = spec
        if kernels.dispatch_device("hashgrid_encode", table) == "cpu":
            ctx.save_for_backward(table, positions)
            return hashgrid_encode_plain(table, positions, spec)
        table_fm = features_minor(table)
        ctx.save_for_backward(table_fm, positions)
        return _launch_forward(table_fm, positions, spec)

    @staticmethod
    def backward(ctx, grad_out):
        saved, positions = ctx.saved_tensors
        args = (positions, grad_out, ctx.spec, ctx.needs_input_grad[1])
        if saved.device.type == "cpu":
            d_table, d_pos = hashgrid_encode_bwd_plain(saved, *args)
        else:
            d_table, d_pos = _launch_backward(saved, *args)
        return (d_table if ctx.needs_input_grad[0] else None), d_pos, None


def hashgrid_encode(table: torch.Tensor, positions: torch.Tensor,
                    spec: HashGridSpec) -> torch.Tensor:
    """Encode positions (..., D) in [0,1] -> (..., L*F) in the table's dtype.

    Differentiable in the table and the positions (the position gradient
    only where the positions require one).  CPU tensors take the plain
    versions; CUDA tensors launch the K4 kernels (and raise if they cannot
    be built or launched)."""
    _check_encode_args("hashgrid_encode", table, positions, spec)
    return _HashGridEncode.apply(table, positions, spec)


hashgrid_encode.launches = 0
