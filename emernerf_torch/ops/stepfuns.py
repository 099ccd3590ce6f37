"""Step-function math for proposal sampling (port of ``emernerf_tpu/ops/stepfuns.py``).

The s<->t ray warps (with the piecewise linear/inverse split at 200 m),
transmittance from density, inverse-CDF importance sampling and the
zip-NeRF interlevel-loss pieces on dense (n_rays, n_edges) tensors.
``importance_sampling`` is the wrapper around the K2 CUDA kernel
(``kernels/csrc/importance_sampling.cu``: a warp per ray; the evenly spaced
CDF positions it inverts at are built once per (count, device) by
``cached_sample_positions``); ``interlevel_loss_levels`` the
differentiable wrapper around K5 (``kernels/csrc/interlevel.cu``: one
launch forward and one backward for every cache level of a branch;
``interlevel_loss`` is its one-level form).  Each has its plain version
beside it (``*_ref``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from emernerf_torch import kernels

_STOT_FWD = {
    "uniform": lambda x: x,
    "lindisp": lambda x: 1.0 / x,
    "sqrt": torch.sqrt,
    "log": torch.log,
    # piecewise: linear below 200m, inverse-distance beyond
    "uniform_lindisp": lambda x: torch.where(x < 200.0, x / 400.0, 1.0 - 1.0 / (2.0 * x / 200.0)),
    "uniform_lindisp_0": lambda x: torch.where(x < 1.0, x / 2.0, 1.0 - 1.0 / (2.0 * x)),
}
_STOT_INV = {
    "uniform": lambda x: x,
    "lindisp": lambda x: 1.0 / x,
    "sqrt": lambda x: x**2,
    "log": torch.exp,
    "uniform_lindisp": lambda x: torch.where(x < 0.5, x * 400.0, 200.0 / (2.0 - 2.0 * x)),
    "uniform_lindisp_0": lambda x: torch.where(x < 0.5, 2.0 * x, 1.0 / (2.0 - 2.0 * x)),
}


def transform_stot(transform_type: str, s_vals: torch.Tensor, t_min, t_max):
    """Map normalized s in [0,1] to metric t in [t_min, t_max]."""
    fwd, inv = _STOT_FWD[transform_type], _STOT_INV[transform_type]
    # s_min/s_max in float32 on the host: a 0-d device tensor built from a
    # Python number would cost a blocking host-to-device copy per call
    s_min = fwd(torch.tensor(t_min, dtype=torch.float32)).item()
    s_max = fwd(torch.tensor(t_max, dtype=torch.float32)).item()
    return inv(s_vals * s_max + (1.0 - s_vals) * s_min)


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Cumulative sum shifted right with a leading zero."""
    c = torch.cumsum(x, dim=dim)
    zero = torch.zeros_like(c.narrow(dim, 0, 1))
    return torch.cat([zero, c.narrow(dim, 0, c.shape[dim] - 1)], dim=dim)


def render_transmittance_from_density(t_starts, t_ends, sigmas):
    """alpha_i = 1 - exp(-sigma_i dt_i); T_i = exp(-sum_{j<i} sigma_j dt_j)."""
    sdt = sigmas * (t_ends - t_starts)
    trans = torch.exp(-exclusive_cumsum(sdt))
    alphas = 1.0 - torch.exp(-sdt)
    return trans, alphas


def sample_positions(n_edges: int, device=None) -> torch.Tensor:
    """The n_edges evenly spaced CDF positions in [pad, 1-pad], bit-equal to
    the reference's ``jnp.linspace`` so both packages invert the CDF at the
    same u.  That is start*(1-step) + stop*step with an exact endpoint,
    where XLA contracts the final multiply-add into one FMA: the product of
    two float32 values is exact in float64, so the FMA is emulated there."""
    pad = 1.0 / (2 * n_edges)
    # float32 endpoints as Python numbers: no host-to-device copy
    start, stop = float(np.float32(pad)), float(np.float32(1.0 - pad))
    f32 = dict(dtype=torch.float32, device=device)
    if n_edges == 1:
        return torch.full((1,), start, **f32)
    div = n_edges - 1
    step = torch.arange(div, **f32) / float(div)
    head = start * (1.0 - step)
    out = (stop * step.double() + head.double()).float()
    return torch.cat([out, torch.full((1,), stop, **f32)])


@functools.lru_cache(maxsize=None)
def cached_sample_positions(n_edges: int, device: torch.device) -> torch.Tensor:
    """:func:`sample_positions` built once per (n_edges, device): K2's
    wrapper reads it on every call and nothing writes it."""
    return sample_positions(n_edges, device)


# K2 stages 2 * (K+1) floats per ray in shared memory, 8 rays per block,
# within 48 KiB
_MAX_IN_EDGES = 768


def _check_sampling_args(name, s_vals, cdfs, jitter):
    if s_vals.shape != cdfs.shape or s_vals.ndim != 2:
        raise ValueError(f"{name}: s_vals and cdfs must both be (R, K+1)")
    if s_vals.dtype != torch.float32 or cdfs.dtype != torch.float32:
        raise ValueError(f"{name}: float32 inputs required")
    if jitter is not None and (jitter.shape != (s_vals.shape[0], 1)
                               or jitter.dtype != torch.float32):
        raise ValueError(f"{name}: jitter must be (R, 1) float32")


def importance_sampling_ref(s_vals, cdfs, n_intervals: int,
                            jitter: Optional[torch.Tensor] = None):
    """Plain version of :func:`importance_sampling`."""
    u = cached_sample_positions(n_intervals + 1, s_vals.device)[None, :]
    u = u + jitter if jitter is not None else u.expand(s_vals.shape[0], -1)
    # normalize the cdf in case opacity saturates below 1
    cdfs = cdfs / cdfs[..., -1:].clamp_min(1e-7)
    k = cdfs.shape[-1]
    idx = torch.searchsorted(cdfs, u.contiguous(), right=True)
    idx_lo = (idx - 1).clamp(0, k - 1)
    idx_hi = idx.clamp(0, k - 1)
    cdf_lo, cdf_hi = cdfs.gather(-1, idx_lo), cdfs.gather(-1, idx_hi)
    s_lo, s_hi = s_vals.gather(-1, idx_lo), s_vals.gather(-1, idx_hi)
    t = torch.nan_to_num((u - cdf_lo) / (cdf_hi - cdf_lo), nan=0.0).clamp(0.0, 1.0)
    return s_lo + t * (s_hi - s_lo)


def importance_sampling(s_vals: torch.Tensor, cdfs: torch.Tensor,
                        n_intervals: int,
                        jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw ``n_intervals`` new intervals from a CDF on interval edges.

    s_vals, cdfs: (R, K+1), edges sorted ascending and a monotone CDF.
    ``jitter``: optional (R, 1) per-ray offset in [-pad, pad] added to the
    evenly spaced positions (stratified sampling); the caller draws it.
    Returns (R, n+1) new edges in s-space.  CPU tensors take the plain
    version; CUDA tensors launch the K2 kernel."""
    name = "importance_sampling"
    _check_sampling_args(name, s_vals, cdfs, jitter)
    if kernels.dispatch_device(name, s_vals) == "cpu":
        return importance_sampling_ref(s_vals, cdfs, n_intervals, jitter)
    extra = () if jitter is None else (jitter,)
    kernels.require_cuda_inputs(name, s_vals, cdfs, *extra)
    r, k1 = s_vals.shape
    if k1 > _MAX_IN_EDGES:
        raise ValueError(f"{name}: at most {_MAX_IN_EDGES} input edges per ray on the card")
    lib = kernels.load()
    m = n_intervals + 1
    u_base = cached_sample_positions(m, s_vals.device)
    out = torch.empty((r, m), dtype=torch.float32, device=s_vals.device)
    if r == 0:
        return out
    err = lib.emt_importance_sampling(
        s_vals.data_ptr(), cdfs.data_ptr(), u_base.data_ptr(),
        None if jitter is None else jitter.data_ptr(), out.data_ptr(),
        r, k1, m, kernels.stream_ptr(s_vals.device),
    )
    kernels.check(err, name)
    importance_sampling.launches += 1
    return out


importance_sampling.launches = 0


# --------------------------------------------------------------------------
# zip-NeRF anti-aliased interlevel loss (K5)
# --------------------------------------------------------------------------

def blur_stepfun(x, y, r: float):
    """Convolve a step function (edges x (R, K+1), values y (R, K)) with a box
    of half-width r: new edges (R, 2K+2) and piecewise-linear values there."""
    xr_cat = torch.cat([x - r, x + r], dim=-1)
    zeros = torch.zeros_like(y[..., :1])
    y1 = (torch.cat([y, zeros], dim=-1) - torch.cat([zeros, y], dim=-1)) / (2.0 * r)
    xr, order = torch.sort(xr_cat, dim=-1, stable=True)
    y2 = torch.gather(torch.cat([y1, -y1], dim=-1), -1, order)[..., :-1]
    yr = torch.cumsum((xr[..., 1:] - xr[..., :-1]) * torch.cumsum(y2, dim=-1),
                      dim=-1).clamp_min(0.0)
    return xr, torch.cat([torch.zeros_like(yr[..., :1]), yr], dim=-1)


def sorted_interp_quad(x, xp, fpdf, fcdf):
    """Quadratic interpolation of the integral of a piecewise-linear pdf at
    sorted queries x (R, M); knots xp/fpdf/fcdf (R, K)."""
    k = xp.shape[-1]
    j = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    idx0 = (j - 1).clamp(0, k - 1)
    idx1 = j.clamp(0, k - 1)
    xp0, xp1 = xp.gather(-1, idx0), xp.gather(-1, idx1)
    fcdf0 = fcdf.gather(-1, idx0)
    fpdf0, fpdf1 = fpdf.gather(-1, idx0), fpdf.gather(-1, idx1)
    offset = torch.nan_to_num((x - xp0) / (xp1 - xp0), nan=0.0).clamp(0.0, 1.0)
    return fcdf0 + (x - xp0) * (fpdf0 + fpdf1 * offset + fpdf0 * (1.0 - offset)) / 2.0


def pdf_outer_loss(s_query, cdfs_query, s_key, cdfs_key, eps: float = 1e-7):
    """Mip-NeRF 360 interlevel loss (the non-anti-aliased branch): proposal
    mass under the outer envelope of the final distribution."""
    k = s_key.shape[-1]
    j_right = torch.searchsorted(s_key.contiguous(), s_query.contiguous(), right=True)
    j_left = (j_right - 1).clamp(0, k - 1)
    j_right = j_right.clamp(0, k - 1)
    w = cdfs_query[..., 1:] - cdfs_query[..., :-1]
    w_outer = cdfs_key.gather(-1, j_right[..., 1:]) - cdfs_key.gather(-1, j_left[..., :-1])
    return (w - w_outer).clamp_min(0.0) ** 2 / (w + eps)


_MAX_EDGES, _MAX_LEVELS = 257, 8


def interlevel_loss_ref(s_final, trans_final, r: float, cache_s, cache_cdfs):
    """Plain version of the K5 forward: (w_s (R, M), per-ray loss sum (R,))."""
    zeros = torch.zeros_like(trans_final[..., :1])
    cdfs = 1.0 - torch.cat([trans_final, zeros], dim=-1)
    w_normalize = (cdfs[..., 1:] - cdfs[..., :-1]) / (s_final[..., 1:] - s_final[..., :-1])
    c, w = blur_stepfun(s_final, w_normalize, r)
    area = 0.5 * (w[..., 1:] + w[..., :-1]) * (c[..., 1:] - c[..., :-1])
    blurred = torch.cat([torch.zeros_like(area[..., :1]), torch.cumsum(area, dim=-1)], dim=-1)
    cdf_interp = sorted_interp_quad(cache_s, c, w, blurred)
    w_s = cdf_interp[..., 1:] - cdf_interp[..., :-1]
    wp = cache_cdfs[..., 1:] - cache_cdfs[..., :-1]
    loss = ((w_s - wp).clamp_min(0.0) ** 2 / (wp + 1e-5)).sum(dim=-1)
    return w_s, loss


def interlevel_loss_levels_ref(caches_s, caches_cdfs, s_final, trans_final, radii):
    """Plain version of the K5 forward over L cache levels: (w_s of each
    level (R, M_l), per-level per-ray loss sums (L, R)), level by level."""
    outs = [interlevel_loss_ref(s_final, trans_final, r, s, c)
            for s, c, r in zip(caches_s, caches_cdfs, radii)]
    return tuple(w for w, _ in outs), torch.stack([loss for _, loss in outs])


class _Level(ctypes.Structure):
    """One cache level as ``kernels/csrc/interlevel.cu:Level`` takes it."""

    _fields_ = [("inp", ctypes.c_void_p), ("cdfs", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("r", ctypes.c_float), ("m1", ctypes.c_int)]


def _levels_arg(ins, cdfs, outs, radii):
    return (_Level * len(ins))(*[_Level(a.data_ptr(), c.data_ptr(), o.data_ptr(), r, c.shape[1])
                                 for a, c, o, r in zip(ins, cdfs, outs, radii)])


def _levels_forward(caches_s, caches_cdfs, s_final, trans_final, radii):
    """The K5 forward over every level in one launch; the plain version for
    CPU tensors.  The outputs share one buffer: the losses (L, R), then each
    level's w_s (R, M_l)."""
    name = "interlevel_loss_levels"
    if kernels.dispatch_device(name, s_final) == "cpu":
        return interlevel_loss_levels_ref(caches_s, caches_cdfs, s_final, trans_final, radii)
    kernels.require_cuda_inputs(name, s_final, trans_final, *caches_s, *caches_cdfs)
    r, k1 = s_final.shape
    n = len(caches_s)
    ms = [c.shape[1] - 1 for c in caches_cdfs]
    buf = torch.empty(r * (n + sum(ms)), dtype=torch.float32, device=s_final.device)
    loss = buf.as_strided((n, r), (r, 1))
    w_s, off = [], n * r
    for m in ms:
        w_s.append(buf.as_strided((r, m), (m, 1), off))
        off += r * m
    if r > 0:
        levels = _levels_arg(caches_s, caches_cdfs, w_s, radii)
        err = kernels.load().emt_interlevel_forward(
            s_final.data_ptr(), trans_final.data_ptr(), ctypes.addressof(levels), n,
            loss.data_ptr(), r, k1, kernels.stream_ptr(s_final.device))
        kernels.check(err, name)
        interlevel_loss_levels.launches += 1
    return tuple(w_s), loss


def interlevel_loss_bwd_ref(w_s, cache_cdfs, g_loss):
    """Plain version of :func:`interlevel_loss_bwd`."""
    wp = cache_cdfs[..., 1:] - cache_cdfs[..., :-1]
    c = (w_s - wp).clamp_min(0.0)
    den = wp + 1e-5
    d_wp = g_loss[:, None] * (-2.0 * c / den - c * c / (den * den))
    d = torch.zeros_like(cache_cdfs)
    d[:, :-1] -= d_wp
    d[:, 1:] += d_wp
    return d


def interlevel_loss_levels_bwd_ref(w_s, caches_cdfs, g_loss):
    """Plain version of :func:`interlevel_loss_levels_bwd`, level by level."""
    return tuple(interlevel_loss_bwd_ref(w, c, g) for w, c, g in zip(w_s, caches_cdfs, g_loss))


def interlevel_loss_levels_bwd(w_s, caches_cdfs, g_loss):
    """K5 backward over L levels in one launch: d cache_cdfs of each level
    (R, M_l + 1) from the per-level per-ray loss cotangent ``g_loss`` (L, R;
    any strides, so the expanded cotangent of a sum needs no copy) and the
    forward's w_s residuals.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    name = "interlevel_loss_levels_bwd"
    if kernels.dispatch_device(name, g_loss) == "cpu":
        return interlevel_loss_levels_bwd_ref(w_s, caches_cdfs, g_loss)
    kernels.require_cuda_inputs(name, *w_s, *caches_cdfs)
    n, r = g_loss.shape
    if (n != len(caches_cdfs) or g_loss.device != caches_cdfs[0].device
            or g_loss.dtype != torch.float32):
        raise ValueError(f"{name}: g_loss must be (L, R) float32 on the caches' device")
    m1s = [c.shape[1] for c in caches_cdfs]
    buf = torch.empty(r * sum(m1s), dtype=torch.float32, device=g_loss.device)
    d, off = [], 0
    for m1 in m1s:
        d.append(buf.as_strided((r, m1), (m1, 1), off))
        off += r * m1
    if r > 0:
        levels = _levels_arg(w_s, caches_cdfs, d, (0.0,) * n)
        err = kernels.load().emt_interlevel_backward(
            ctypes.addressof(levels), n, g_loss.data_ptr(), *g_loss.stride(), r,
            kernels.stream_ptr(g_loss.device))
        kernels.check(err, name)
        interlevel_loss_levels_bwd.launches += 1
    return tuple(d)


interlevel_loss_levels_bwd.launches = 0


class _InterlevelLevels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s_final, trans_final, radii, *caches):
        n = len(caches) // 2
        w_s, loss = _levels_forward(caches[:n], caches[n:], s_final, trans_final, radii)
        ctx.save_for_backward(*w_s, *caches[n:])
        return loss

    @staticmethod
    def backward(ctx, g_loss):
        saved = ctx.saved_tensors
        n = len(saved) // 2
        d = interlevel_loss_levels_bwd(saved[:n], saved[n:], g_loss)
        return (None, None, None) + (None,) * n + d


def _check_levels(name, caches_s, caches_cdfs, s_final, trans_final, radii):
    n = len(caches_s)
    if not 1 <= n <= _MAX_LEVELS or len(caches_cdfs) != n:
        raise ValueError(f"{name}: 1 to {_MAX_LEVELS} levels, cache edges and CDFs for each")
    if len(radii) != n:
        raise ValueError(f"{name}: one radius per cache level")
    for t in (s_final, trans_final, *caches_s, *caches_cdfs):
        if t.dtype != torch.float32 or t.ndim != 2:
            raise ValueError(f"{name}: (R, n) float32 inputs required")
    r, k1 = s_final.shape
    if trans_final.shape != (r, k1 - 1):
        raise ValueError(f"{name}: s_final (R, K+1), trans_final (R, K)")
    for s, c in zip(caches_s, caches_cdfs):
        if s.shape != c.shape or s.shape[0] != r:
            raise ValueError(f"{name}: each level's cache edges and CDFs (R, M+1), R of s_final")
    if not all(2 <= k <= _MAX_EDGES for k in (k1, *(s.shape[1] for s in caches_s))):
        raise ValueError(f"{name}: 2 to {_MAX_EDGES} edges per ray")


def interlevel_loss_levels(caches_s, caches_cdfs, s_final: torch.Tensor,
                           trans_final: torch.Tensor, radii) -> torch.Tensor:
    """Per-level, per-ray sums over the M_l proposal intervals of the
    anti-aliased interlevel loss, (L, R): clip(w_s - wp, 0)^2 / (wp + 1e-5),
    where w_s is the final distribution (edges s_final (R, K+1),
    transmittance trans_final (R, K)) blurred with half-width radii[l] and
    integrated over level l's cache edges caches_s[l] (R, M_l + 1), and wp
    = diff(caches_cdfs[l]).  One K5 launch forward and one backward for all
    levels.  Differentiable in caches_cdfs only (the rest is detached, as
    in the reference)."""
    name = "interlevel_loss_levels"
    radii = tuple(float(r) for r in radii)
    _check_levels(name, caches_s, caches_cdfs, s_final, trans_final, radii)
    if any(t.requires_grad for t in (s_final, trans_final, *caches_s)):
        raise ValueError(f"{name}: only cache_cdfs (the caches' CDFs) take a gradient")
    if torch.is_grad_enabled() and any(c.requires_grad for c in caches_cdfs):
        return _InterlevelLevels.apply(s_final, trans_final, radii, *caches_s, *caches_cdfs)
    return _levels_forward(caches_s, caches_cdfs, s_final, trans_final, radii)[1]


interlevel_loss_levels.launches = 0


def _interlevel_forward(s_final, trans_final, r, cache_s, cache_cdfs):
    """The K5 forward of one level: (w_s (R, M), per-ray loss sum (R,))."""
    (w_s,), loss = _levels_forward((cache_s,), (cache_cdfs,), s_final, trans_final, (float(r),))
    return w_s, loss[0]


def interlevel_loss_bwd(w_s, cache_cdfs, g_loss):
    """K5 backward of one level: d cache_cdfs (R, M+1) from the per-ray
    loss cotangent (R,) and the forward's w_s residual."""
    return interlevel_loss_levels_bwd((w_s,), (cache_cdfs,), g_loss[None])[0]


def interlevel_loss(cache_s: torch.Tensor, cache_cdfs: torch.Tensor,
                    s_final: torch.Tensor, trans_final: torch.Tensor,
                    r: float) -> torch.Tensor:
    """:func:`interlevel_loss_levels` of one cache level: the per-ray loss
    sums (R,) at half-width r."""
    return interlevel_loss_levels((cache_s,), (cache_cdfs,), s_final, trans_final, (r,))[0]
