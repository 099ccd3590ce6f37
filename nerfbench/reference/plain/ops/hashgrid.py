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
``hashgrid_encode`` is the differentiable function of the two.  It saves
only the table and the positions and recomputes the rest in the backward,
as the JAX custom VJP does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import List, Tuple

import numpy as np
import torch


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


class _HashGridEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, positions, spec):
        ctx.spec = spec
        ctx.save_for_backward(table, positions)
        return hashgrid_encode_plain(table, positions, spec)

    @staticmethod
    def backward(ctx, grad_out):
        table, positions = ctx.saved_tensors
        d_table, d_pos = hashgrid_encode_bwd_plain(table, positions, grad_out, ctx.spec,
                                                   ctx.needs_input_grad[1])
        return (d_table if ctx.needs_input_grad[0] else None), d_pos, None


def hashgrid_encode(table: torch.Tensor, positions: torch.Tensor,
                    spec: HashGridSpec) -> torch.Tensor:
    """Encode positions (..., D) in [0,1] -> (..., L*F) in the table's dtype.

    Differentiable in the table and the positions (the position gradient
    only where the positions require one)."""
    return _HashGridEncode.apply(table, positions, spec)

