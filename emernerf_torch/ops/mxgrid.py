"""MX grid encoding (port of ``emernerf_tpu/ops/mxgrid.py``, kernel K12).

A level ladder like a brick grid's (the same growth factor between
``base_resolution`` and ``max_resolution``): the first ``n_brick_levels``
levels are a dense brick grid (K1), the rest are factored scales.  A
factored scale keeps, per input axis, a clamped coarse line and a periodic
line of ``line_block`` entries of ``W = rank * F`` lanes; for a point and
scale s, per axis a with coordinate c,

  u_a = sum_j tent(c (block - 1) - j) coarse_a[s][j]
      + sum_j tent_circ((c freq_a[s]) mod 1 * block - j) periodic_a[s][j],
  tent(d) = max(0, 1 - |d|)  (tent_circ: the circular distance),

and the scale's feature f is ``sum_r prod_a u_a[r F + f]``.  All parts live
in one flat parameter: ``[brick table, axis-0 lines, axis-1 lines, ...]``,
each axis's lines ``(2 S, block, W)`` (coarse scales, then periodic),
zero-padded to a multiple of 1024.

The JAX package evaluates the tents densely, as batched matmuls of
``(2S, chunk, block)`` tent matrices.  Only two entries per line are
non-zero, so the port gathers them: ``mx_lines_encode`` (K12 forward) and
``mx_lines_encode_bwd`` (K12 backward: the line gradients and, where the
positions need one, the position gradient), CUDA kernels in
``kernels/csrc/mxgrid.cu``; the plain versions ``mx_lines_encode_ref`` and
``mx_lines_encode_bwd_ref`` are the same arithmetic in PyTorch, which CPU
tensors take.  Both reproduce what autodiff of the tents gives: a weight's
derivative at a knot (``|u - j| = 1`` ties ``max`` at 0, counted 0.5; and
``|0|``'s slope is +1), so the position gradient at a knot reads three
rows, not the lerp's slope.  A bf16 computation rounds the line values and
the tent weights to bf16, as the JAX package casts the tents to the table's
dtype; products, sums and the output are fp32.  The line gradient is summed
in fp32 and, for a bf16 computation, rounded once to bf16 (the JAX package
sums its chunks in the table's dtype).

On the card a block copies one value slot (``LP`` consecutive values of
every row, ``plan_slots``) of one scale's lines into shared memory and a
group of ``LP`` lanes works on a point, element ``v LP + l`` of slot ``v`` in
lane ``l``.  The forward walks the slots in order and the rank sum continues
across them, adding the ranks in order as the plain version does, so the
forward matches the kernel bit for bit.  The backward gives the line and
position gradients in one pass; the position gradient's partials per
(scale, slot) are summed in a fixed order, so it is the same from run to
run.
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import cached_property
from typing import Tuple

import numpy as np
import torch

from emernerf_torch import kernels
from emernerf_torch.ops.brickgrid import BrickGridSpec, brickgrid_encode, init_brickgrid_table

# every brick level's dense slice stays at or under this many table elements
# (the JAX package's one-hot budget, which sizes the brick prefix)
_ONEHOT_BUDGET = 1 << 19
MAX_SCALES = 32


@dataclasses.dataclass(frozen=True)
class MXGridSpec:
    """Dense brick prefix + blocked CP lines; the JAX ``MXGridSpec``'s fields
    and geometry.  ``n_output_dims = n_levels * F``."""

    n_input_dims: int
    n_levels: int
    base_resolution: int
    max_resolution: int
    n_features_per_level: int
    rank: int = 16
    # 4D grids: nominal resolution of the time axis lines
    time_resolution: int = 64
    # points per chunk of the plain versions (the JAX package's tent chunk)
    chunk: int = 8192
    # factor init std
    init_scale: float = 0.2
    # nominal line resolutions above this are clamped
    max_line_resolution: int = 4096
    # entries per line
    line_block: int = 128

    @property
    def growth_factor(self) -> float:
        if self.n_levels <= 1:
            return 1.0
        return float(np.exp((np.log(self.max_resolution) - np.log(self.base_resolution))
                            / (self.n_levels - 1)))

    @property
    def level_resolutions(self) -> np.ndarray:
        b = self.growth_factor
        return np.array([int(np.floor(self.base_resolution * b ** l))
                         for l in range(self.n_levels)], dtype=np.int64)

    @property
    def spatial_dims(self) -> int:
        return min(self.n_input_dims, 3)

    @property
    def has_time(self) -> bool:
        return self.n_input_dims == 4

    def _make_brick(self, nb: int) -> BrickGridSpec:
        """The first ``nb`` levels as a brick grid whose table holds every
        level's dense cells (no level hashes)."""
        res = self.level_resolutions
        f = self.n_features_per_level
        bs = 2 if f == 1 and self.n_input_dims == 3 else 1
        spec = BrickGridSpec(
            n_input_dims=self.n_input_dims, n_levels=nb,
            base_resolution=self.base_resolution, max_resolution=int(res[nb - 1]),
            log2_bricks=4, n_features_per_level=f, log2_brick_size=bs,
            time_pair=self.has_time)
        need = 1
        for li in range(nb):
            cells = int(spec.brick_resolutions[li]) ** spec.spatial_dims
            if spec.has_time:
                t = int(spec.level_resolutions[li])
                cells *= t if spec.uses_time_pair else t + 1
            need = max(need, cells)
        return dataclasses.replace(spec, log2_bricks=max(int(np.ceil(np.log2(need))), 4))

    @cached_property
    def n_brick_levels(self) -> int:
        """The longest level prefix that stays dense as a brick grid with
        every level under the one-hot budget (0 when level 0 exceeds it);
        at least one factored scale remains."""
        best = 0
        for nb in range(1, self.n_levels):
            spec = self._make_brick(nb)
            if spec.level_uses_hash.any() or not bool(
                    (spec.level_rows * spec.row_width <= _ONEHOT_BUDGET).all()):
                break
            best = nb
        return best

    @cached_property
    def brick_spec(self):
        nb = self.n_brick_levels
        return self._make_brick(nb) if nb else None

    @property
    def factored_resolutions(self) -> np.ndarray:
        return np.minimum(self.level_resolutions[self.n_brick_levels:],
                          self.max_line_resolution)

    @property
    def n_scales(self) -> int:
        return self.n_levels - self.n_brick_levels

    @property
    def factor_width(self) -> int:
        return self.rank * self.n_features_per_level

    @property
    def axes_per_scale(self) -> int:
        return self.spatial_dims + (1 if self.has_time else 0)

    def axis_freqs(self, axis: int) -> np.ndarray:
        """Periods of the periodic line per scale for one axis (>= 1)."""
        if self.has_time and axis == self.spatial_dims:
            res = np.full(self.n_scales, self.time_resolution, np.float64)
        else:
            res = self.factored_resolutions.astype(np.float64)
        return np.maximum(res / float(self.line_block), 1.0)

    @property
    def axis_part(self) -> int:
        """Elements of one axis's lines (coarse + periodic, every scale)."""
        return 2 * self.n_scales * self.line_block * self.factor_width

    @property
    def part_sizes(self) -> Tuple[int, ...]:
        """Elements of [brick table, axis-0 lines, axis-1 lines, ...]."""
        bspec = self.brick_spec
        sizes = [int(np.prod(bspec.table_shape)) if bspec else 0]
        sizes.extend([self.axis_part] * self.axes_per_scale)
        return tuple(sizes)

    @property
    def num_parameters(self) -> int:
        return sum(self.part_sizes)

    @property
    def table_shape(self) -> Tuple[int]:
        # padded to a multiple of 1024, so ZeRO's slabs split it evenly
        return (-(-self.num_parameters // 1024) * 1024,)

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def level_scales(self) -> np.ndarray:
        return self.level_resolutions.astype(np.float64)

    @property
    def lanes(self) -> int:
        """Lanes holding one line row on the card: 32, or the power of two at
        or above a narrower W."""
        return 32 if self.factor_width >= 32 else 1 << (self.factor_width - 1).bit_length()


def init_mxgrid_table(spec: MXGridSpec, dtype=torch.float32, device=None,
                      generator=None) -> torch.Tensor:
    """Brick part U(-1e-4, 1e-4) (the brick tables' init), lines
    N(0, init_scale^2), the padding zero."""
    parts = []
    if spec.brick_spec is not None:
        parts.append(init_brickgrid_table(spec.brick_spec, device=device,
                                          generator=generator).reshape(-1))
    lines = torch.empty(sum(spec.part_sizes[1:]), dtype=torch.float32, device=device)
    lines.normal_(0.0, 1.0, generator=generator)
    parts.append(spec.init_scale * lines)
    flat = torch.cat(parts)
    flat = torch.nn.functional.pad(flat, (0, spec.table_shape[0] - flat.numel()))
    return flat.to(dtype)


# ---------------------------------------------------------------------------
# plain versions of K12


def _freqs(spec: MXGridSpec, device) -> torch.Tensor:
    """(A, S) float32 periods of the periodic lines."""
    return torch.tensor(np.stack([spec.axis_freqs(a) for a in range(spec.axes_per_scale)]),
                        dtype=torch.float32, device=device)


def _rem1(x: torch.Tensor) -> torch.Tensor:
    """``x mod 1`` as ``jnp.remainder`` computes it: fmod, plus 1 where the
    remainder is negative and non-zero."""
    r = torch.fmod(x, 1.0)
    return torch.where(r < 0, r + 1.0, r)


def _tent(u: torch.Tensor, j: torch.Tensor, block: int, periodic: bool):
    """The tent's weight ``max(0, 1 - dist(u, j))`` and its derivative in u
    as autodiff of that expression gives it (``max``'s tie at 0 counts 0.5,
    ``|x|``'s slope at 0 is +1, ``min``'s tie counts 0.5 each)."""
    diff = u - j
    d = diff.abs()
    sgn = torch.where(diff >= 0, 1.0, -1.0)
    if periodic:
        e = block - d
        slope = torch.where(d < e, sgn, torch.where(d > e, -sgn, torch.zeros_like(sgn)))
        d = torch.minimum(d, e)
    else:
        slope = sgn
    y = 1.0 - d
    w = torch.clamp_min(y, 0.0)
    dmax = torch.where(y > 0, 1.0, torch.where(y == 0, 0.5, 0.0))
    return w, -dmax * slope


def _axis_rows(c: torch.Tensor, freqs: torch.Tensor, block: int, offsets=(0, 1)):
    """Per candidate offset t: (rows, weights, weight derivatives) of the
    coarse line ((m,) each) and the periodic lines ((S, m) each) at
    coordinates ``c`` (m,), candidates ``floor(u) + t``; the coarse rows out
    of the line carry weight 0 (their row clamped)."""
    uc = c * float(block - 1)
    fl = torch.floor(uc)
    up = _rem1(c[None, :] * freqs[:, None]) * float(block)
    fk = torch.floor(up)
    coarse, periodic = [], []
    for t in offsets:
        j = fl + t
        w, dw = _tent(uc, j, block, periodic=False)
        ok = (j >= 0) & (j <= block - 1)
        coarse.append((j.clamp(0, block - 1).long(), torch.where(ok, w, 0.0),
                       torch.where(ok, dw, 0.0)))
        k = torch.remainder(fk + t, float(block))
        w, dw = _tent(up, k, block, periodic=True)
        periodic.append((k.long(), w, dw))
    return coarse, periodic, up


def _as_compute(v: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Values as a ``compute_dtype`` computation holds them, in fp32."""
    return v.to(compute_dtype).float()


def _lines_view(lines: torch.Tensor, spec: MXGridSpec, compute_dtype) -> torch.Tensor:
    """(A, 2S, block, W) fp32 line values of the computation."""
    return _as_compute(lines, compute_dtype).view(
        spec.axes_per_scale, 2 * spec.n_scales, spec.line_block, spec.factor_width)


def _axis_values(tab, a: int, s: int, ns: int, coarse, periodic, compute_dtype):
    """u_a (m, W) at scale s: coarse + periodic, each two weighted rows."""
    (jc0, wc0, _), (jc1, wc1, _) = coarse
    (jp0, wp0, _), (jp1, wp1, _) = periodic
    wc0, wc1 = _as_compute(wc0, compute_dtype), _as_compute(wc1, compute_dtype)
    wp0, wp1 = _as_compute(wp0[s], compute_dtype), _as_compute(wp1[s], compute_dtype)
    cl, pl = tab[a, s], tab[a, ns + s]
    cv = wc0[:, None] * cl[jc0] + wc1[:, None] * cl[jc1]
    pv = wp0[:, None] * pl[jp0[s]] + wp1[:, None] * pl[jp1[s]]
    return cv + pv


def _rank_sum(prod: torch.Tensor, spec: MXGridSpec) -> torch.Tensor:
    """(m, W) -> (m, F): the ranks added in order (the kernel's order)."""
    v = prod.view(prod.shape[0], spec.rank, spec.n_features_per_level)
    acc = v[:, 0]
    for r in range(1, spec.rank):
        acc = acc + v[:, r]
    return acc


def _chunks(n: int, chunk: int):
    for lo in range(0, n, max(chunk, 1)):
        yield lo, min(lo + chunk, n)


def mx_lines_encode_ref(lines: torch.Tensor, positions: torch.Tensor, spec: MXGridSpec,
                        compute_dtype=None) -> torch.Tensor:
    """Plain version of K12 forward: lines (the flat line parts), positions
    (n, D) -> (n, S * F) fp32, chunked by ``spec.chunk``."""
    compute_dtype = compute_dtype or lines.dtype
    ns, blk = spec.n_scales, spec.line_block
    tab = _lines_view(lines, spec, compute_dtype)
    freqs = _freqs(spec, positions.device)
    x = positions.float()
    out = torch.empty(x.shape[0], ns * spec.n_features_per_level, device=x.device)
    for lo, hi in _chunks(x.shape[0], spec.chunk):
        geo = [_axis_rows(x[lo:hi, a], freqs[a], blk) for a in range(spec.axes_per_scale)]
        feats = []
        for s in range(ns):
            prod = None
            for a, (coarse, periodic, _) in enumerate(geo):
                u = _axis_values(tab, a, s, ns, coarse, periodic, compute_dtype)
                prod = u if prod is None else prod * u
            feats.append(_rank_sum(prod, spec))
        out[lo:hi] = torch.cat(feats, -1)
    return out


def _axis_cotangents(us, g_prod):
    """Reverse mode through prod = ((u_0 u_1) u_2) ...: the cotangent of
    every u_a, in autodiff's order of products."""
    prods = [us[0]]
    for u in us[1:]:
        prods.append(prods[-1] * u)
    cts = [None] * len(us)
    ct = g_prod
    for a in range(len(us) - 1, 0, -1):
        cts[a] = ct * prods[a - 1]
        ct = ct * us[a]
    cts[0] = ct
    return cts


def mx_lines_encode_bwd_ref(lines: torch.Tensor, positions: torch.Tensor,
                            grad_out: torch.Tensor, spec: MXGridSpec, needs_pos_grad: bool,
                            compute_dtype=None):
    """Plain version of K12 backward: (d lines in the lines' dtype, d
    positions (n, D) fp32 or None).  The line gradient adds w_j * du_a of
    every (point, scale, axis, row j) into a zeroed fp32 buffer and rounds
    it once to the compute dtype; the position gradient of axis a is, per
    scale, sum_e du_a[e] * ((block - 1) sum_j dw_j coarse[j][e] + block *
    freq sum_j dw_j periodic[j][e]), over the candidate rows floor(u) - 1,
    floor(u), floor(u) + 1."""
    stored = lines.dtype
    compute_dtype = compute_dtype or stored
    ns, blk, f, w = spec.n_scales, spec.line_block, spec.n_features_per_level, spec.factor_width
    tab = _lines_view(lines, spec, compute_dtype)
    freqs = _freqs(spec, positions.device)
    x = positions.float()
    n, naxes = x.shape[0], spec.axes_per_scale
    g = grad_out.reshape(n, ns, f).float()
    d_tab = torch.zeros(naxes, 2 * ns, blk, w, device=x.device)
    d_pos = torch.zeros(n, spec.n_input_dims, device=x.device) if needs_pos_grad else None
    offsets = (-1, 0, 1) if needs_pos_grad else (0, 1)
    for lo, hi in _chunks(n, spec.chunk):
        geo = [_axis_rows(x[lo:hi, a], freqs[a], blk, offsets) for a in range(naxes)]
        fwd = [(c[-2:], p[-2:]) for c, p, _ in geo]  # the forward's candidates
        for s in range(ns):
            us = [_axis_values(tab, a, s, ns, c, p, compute_dtype) for a, (c, p) in enumerate(fwd)]
            g_prod = g[lo:hi, s].repeat(1, w // f)  # lane e takes feature e % F
            for a, du in enumerate(_axis_cotangents(us, g_prod)):
                coarse, periodic = fwd[a]
                for (j, wt, _) in coarse:
                    d_tab[a, s].index_add_(0, j, _as_compute(wt, compute_dtype)[:, None] * du)
                for (j, wt, _) in periodic:
                    d_tab[a, ns + s].index_add_(0, j[s],
                                                _as_compute(wt[s], compute_dtype)[:, None] * du)
                if not needs_pos_grad:
                    continue
                coarse, periodic, _ = geo[a]
                dc = sum(dw[:, None] * tab[a, s][j] for j, _, dw in coarse)
                dp = sum(dw[s][:, None] * tab[a, ns + s][j[s]] for j, _, dw in periodic)
                du_dc = dc * float(blk - 1) + dp * (float(blk) * freqs[a, s])
                d_pos[lo:hi, a] += (du * du_dc).sum(-1)
    d_lines = d_tab.reshape(-1).to(compute_dtype).to(stored)
    return d_lines, d_pos


# ---------------------------------------------------------------------------
# K12 on the card


class _MxParams(ctypes.Structure):
    """Mirror of ``MxParams`` in kernels/csrc/mxgrid.cu."""

    _fields_ = [
        ("n_dims", ctypes.c_int),
        ("n_axes", ctypes.c_int),
        ("n_scales", ctypes.c_int),
        ("block", ctypes.c_int),
        ("width", ctypes.c_int),
        ("n_features", ctypes.c_int),
        ("lanes", ctypes.c_int),
        ("values", ctypes.c_int),
        ("bwd_lanes", ctypes.c_int),
        ("bwd_values", ctypes.c_int),
        ("axis_part", ctypes.c_longlong),
        ("freqs", ctypes.c_float * (4 * MAX_SCALES)),
    ]


def _kernel_params(spec: MXGridSpec, lines_dtype=torch.float32,
                   compute_dtype=torch.float32) -> _MxParams:
    plan = plan_slots(spec, lines_dtype, compute_dtype)
    p = _MxParams()
    p.n_dims, p.n_axes, p.n_scales = spec.n_input_dims, spec.axes_per_scale, spec.n_scales
    p.block, p.width, p.n_features = spec.line_block, spec.factor_width, spec.n_features_per_level
    p.lanes, p.bwd_lanes = plan.lanes, plan.bwd_lanes
    p.values = -(-spec.factor_width // plan.lanes)
    p.bwd_values = -(-spec.factor_width // plan.bwd_lanes)
    p.axis_part = spec.axis_part
    for a in range(spec.axes_per_scale):
        for s, fr in enumerate(spec.axis_freqs(a)):
            p.freqs[a * MAX_SCALES + s] = float(fr)
    return p


_DTYPES = (torch.float32, torch.bfloat16)

# an H100 block's shared memory, and K12's blocks (kernels/csrc/mxgrid.cu:
# kThreads, kFwdWords, kBwdWords, layout)
_SHARED_BYTES = 232_448
_THREADS = 1024
_FWD_WORDS, _BWD_WORDS = 8, 16


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def shared_bytes(spec: MXGridSpec, lanes: int, staged_bytes: int, backward: bool) -> int:
    """Dynamic shared memory of a K12 block with value slots of ``lanes``
    (``layout`` in kernels/csrc/mxgrid.cu): the slice of the lines (every
    axis, both lines, every row, ``lanes`` values of ``staged_bytes``);
    forward: the lane groups' tent tables (``lanes // 4`` points, at least
    one, by 4 axes by 8 words) and a float a thread; backward (a batch of
    a point a group of ``lanes``): the fp32 partials (rows of ``lanes + 1``
    floats), the batch's tent table (4 axes by 16 words a point), its du
    (4 axes by batch by rows of ``lanes + 4`` floats) and a tag byte a
    (warp, row)."""
    rows = spec.axes_per_scale * 2 * spec.line_block
    groups = _THREADS // lanes
    total = _align16(rows * lanes * staged_bytes)
    if backward:
        du_stride = lanes + 4 if lanes >= 4 else lanes + 1
        return (total + _align16(rows * (lanes + 1) * 4) + groups * 4 * _BWD_WORDS * 4
                + 4 * groups * du_stride * 4 + _align16(_THREADS // 32 * spec.line_block))
    return total + groups * max(lanes // 4, 1) * 4 * _FWD_WORDS * 4 + _THREADS * 4


@dataclasses.dataclass(frozen=True)
class MxPlan:
    """K12's value slots and shared bytes: the forward's ``lanes`` (at least
    F: a lane per feature adds the slot's ranks) and the backward's."""

    lanes: int
    shared: int
    bwd_lanes: int
    bwd_shared: int


def plan_slots(spec: MXGridSpec, lines_dtype=torch.float32,
               compute_dtype=torch.float32) -> MxPlan:
    """The widest value slot (a power of two, at most ``spec.lanes``) whose
    block fits in shared memory, for the forward and the backward.  The
    slice is held as bf16 where the lines or the computation are bf16.
    Raises where no slot fits."""
    staged = 2 if torch.bfloat16 in (lines_dtype, compute_dtype) else 4

    def widest(backward: bool, least: int):
        lanes = spec.lanes
        while lanes >= least:
            total = shared_bytes(spec, lanes, staged, backward)
            if total <= _SHARED_BYTES:
                return lanes, total
            lanes //= 2
        raise ValueError(
            f"mx grid: line_block={spec.line_block}, {spec.axes_per_scale} axes: no value slot "
            f"of {least} to {spec.lanes} lanes fits a {'backward' if backward else 'forward'} "
            f"block in {_SHARED_BYTES} bytes of shared memory")

    lanes, shared = widest(False, spec.n_features_per_level)
    bwd_lanes, bwd_shared = widest(True, 1)
    return MxPlan(lanes, shared, bwd_lanes, bwd_shared)


def check_spec(spec: MXGridSpec) -> None:
    """The lines K12 takes: F <= 32, W <= 256, at most ``MAX_SCALES`` scales,
    line_block >= 4, and a value slot of fp32 lines that fits a block's
    shared memory (``plan_slots``)."""
    f, w, blk = spec.n_features_per_level, spec.factor_width, spec.line_block
    if not (f <= 32 and w <= 256 and spec.n_scales <= MAX_SCALES and blk >= 4):
        raise ValueError(f"mx grid: F={f}, W={w}, {spec.n_scales} scales, line_block={blk}: "
                         f"F <= 32, W <= 256, <= {MAX_SCALES} scales and line_block >= 4 "
                         "are supported")
    plan_slots(spec)


def _check_lines_args(name, lines, positions, spec, compute_dtype):
    if lines.dim() != 1 or lines.numel() != sum(spec.part_sizes[1:]):
        raise ValueError(f"{name}: lines {tuple(lines.shape)}, want ({sum(spec.part_sizes[1:])},)")
    if lines.dtype not in _DTYPES or compute_dtype not in _DTYPES:
        raise ValueError(f"{name}: lines dtype {lines.dtype}, compute dtype {compute_dtype}")
    if positions.dim() != 2 or positions.shape[1] != spec.n_input_dims \
            or positions.dtype != torch.float32:
        raise ValueError(f"{name}: positions must be (n, {spec.n_input_dims}) float32")
    check_spec(spec)


def _is_bf16(dtype) -> int:
    return int(dtype == torch.bfloat16)


def mx_lines_encode(lines: torch.Tensor, positions: torch.Tensor, spec: MXGridSpec,
                    compute_dtype=None) -> torch.Tensor:
    """K12 forward: (n, S * F) fp32.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    name = "mx_lines_encode"
    compute_dtype = compute_dtype or lines.dtype
    _check_lines_args(name, lines, positions, spec, compute_dtype)
    if kernels.dispatch_device(name, lines) == "cpu":
        return mx_lines_encode_ref(lines, positions, spec, compute_dtype)
    kernels.require_cuda_inputs(name, lines, positions)
    n = positions.shape[0]
    out = torch.empty(n, spec.n_scales * spec.n_features_per_level, device=lines.device)
    if n == 0:
        return out
    lib = kernels.load()
    params = _kernel_params(spec, lines.dtype, compute_dtype)
    err = lib.emt_mxgrid_encode(lines.data_ptr(), _is_bf16(lines.dtype),
                                _is_bf16(compute_dtype), positions.data_ptr(), out.data_ptr(),
                                n, ctypes.addressof(params), kernels.stream_ptr(lines.device))
    kernels.check(err, name)
    mx_lines_encode.launches += 1
    return out


mx_lines_encode.launches = 0


def mx_lines_encode_bwd(lines: torch.Tensor, positions: torch.Tensor, grad_out: torch.Tensor,
                        spec: MXGridSpec, needs_pos_grad: bool, compute_dtype=None):
    """K12 backward: (d lines in the lines' dtype, d positions or None).
    CPU tensors take the plain version; CUDA tensors launch the kernels
    (the line and position gradients in one pass, then one pass that sums
    the position gradient's partials and rounds a bf16 computation's line
    gradient)."""
    name = "mx_lines_encode_bwd"
    compute_dtype = compute_dtype or lines.dtype
    _check_lines_args(name, lines, positions, spec, compute_dtype)
    if kernels.dispatch_device(name, lines) == "cpu":
        return mx_lines_encode_bwd_ref(lines, positions, grad_out, spec, needs_pos_grad,
                                       compute_dtype)
    grad_out = grad_out.float().contiguous()
    kernels.require_cuda_inputs(name, lines, positions, grad_out)
    n = positions.shape[0]
    d_lines = torch.zeros(lines.numel(), dtype=torch.float32, device=lines.device)
    # every element of d_pos is written by the kernels' last pass
    d_pos = torch.empty_like(positions) if needs_pos_grad else None
    if n > 0:
        lib = kernels.load()
        params = _kernel_params(spec, lines.dtype, compute_dtype)
        # the position gradient's partials, one per (scale, slot, point)
        scratch = None if d_pos is None else torch.empty(
            (spec.n_scales * params.bwd_values, n, spec.n_input_dims), device=lines.device)
        err = lib.emt_mxgrid_backward(
            lines.data_ptr(), _is_bf16(lines.dtype), _is_bf16(compute_dtype),
            positions.data_ptr(), grad_out.data_ptr(), d_lines.data_ptr(),
            None if d_pos is None else d_pos.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n, ctypes.addressof(params),
            kernels.stream_ptr(lines.device))
        kernels.check(err, name)
        mx_lines_encode_bwd.launches += 1
    return d_lines.to(lines.dtype), d_pos


mx_lines_encode_bwd.launches = 0


class _MxLinesEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lines, positions, spec, compute_dtype):
        ctx.spec, ctx.compute_dtype = spec, compute_dtype
        ctx.save_for_backward(lines, positions)
        return mx_lines_encode(lines, positions, spec, compute_dtype)

    @staticmethod
    def backward(ctx, grad_out):
        lines, positions = ctx.saved_tensors
        d_lines, d_pos = mx_lines_encode_bwd(lines, positions, grad_out, ctx.spec,
                                             ctx.needs_input_grad[1], ctx.compute_dtype)
        return (d_lines if ctx.needs_input_grad[0] else None), d_pos, None, None


def mxgrid_encode(table: torch.Tensor, positions: torch.Tensor, spec: MXGridSpec,
                  compute_dtype=None) -> torch.Tensor:
    """Encode positions (..., D) -> (..., n_levels * F) fp32: K1 on the brick
    prefix, K12 on the lines, concatenated.  ``table`` is the flat parameter
    as stored; ``compute_dtype`` (default: the table's) is what the encode
    computes in.  Differentiable in the table and the positions."""
    compute_dtype = compute_dtype or table.dtype
    if tuple(table.shape) != spec.table_shape:
        raise ValueError(f"mxgrid_encode: table {tuple(table.shape)} != {spec.table_shape}")
    d = spec.n_input_dims
    batch = positions.shape[:-1]
    x = positions.reshape(-1, d)
    sizes = spec.part_sizes
    outs = []
    if spec.brick_spec is not None:
        brick = table[:sizes[0]].view(spec.brick_spec.table_shape)
        outs.append(brickgrid_encode(brick, x, spec.brick_spec, compute_dtype).float())
    if spec.n_scales:
        lines = table[sizes[0]:spec.num_parameters]
        outs.append(_MxLinesEncode.apply(lines, x, spec, compute_dtype))
    out = torch.cat(outs, -1) if len(outs) > 1 else outs[0]
    return out.reshape(*batch, spec.n_output_dims)
