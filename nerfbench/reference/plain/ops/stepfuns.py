"""Step-function math for proposal sampling (port of ``emernerf_tpu/ops/stepfuns.py``).

The s<->t ray warps (with the piecewise linear/inverse split at 200 m),
transmittance from density, inverse-CDF importance sampling and the
zip-NeRF interlevel-loss pieces on dense (n_rays, n_edges) tensors.
The port's K2 (importance sampling) and K5 (the interlevel loss) are kept
here as their plain versions only (``*_ref``), which the wrappers call.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


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
    """:func:`sample_positions` built once per (n_edges, device)."""
    return sample_positions(n_edges, device)


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
    Returns (R, n+1) new edges in s-space."""
    return importance_sampling_ref(s_vals, cdfs, n_intervals, jitter)


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


def interlevel_loss_bwd_ref(w_s, cache_cdfs, g_loss):
    """The interlevel loss's backward of one level: d cache_cdfs (R, M+1)
    from the per-ray loss cotangent (R,) and the forward's w_s residual."""
    wp = cache_cdfs[..., 1:] - cache_cdfs[..., :-1]
    c = (w_s - wp).clamp_min(0.0)
    den = wp + 1e-5
    d_wp = g_loss[:, None] * (-2.0 * c / den - c * c / (den * den))
    d = torch.zeros_like(cache_cdfs)
    d[:, :-1] -= d_wp
    d[:, 1:] += d_wp
    return d


def interlevel_loss_levels_bwd_ref(w_s, caches_cdfs, g_loss):
    """:func:`interlevel_loss_bwd_ref`, level by level."""
    return tuple(interlevel_loss_bwd_ref(w, c, g) for w, c, g in zip(w_s, caches_cdfs, g_loss))


class _InterlevelLevels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s_final, trans_final, radii, *caches):
        n = len(caches) // 2
        w_s, loss = interlevel_loss_levels_ref(caches[:n], caches[n:], s_final, trans_final,
                                               radii)
        ctx.save_for_backward(*w_s, *caches[n:])
        return loss

    @staticmethod
    def backward(ctx, g_loss):
        saved = ctx.saved_tensors
        n = len(saved) // 2
        d = interlevel_loss_levels_bwd_ref(saved[:n], saved[n:], g_loss)
        return (None, None, None) + (None,) * n + d


def interlevel_loss_levels(caches_s, caches_cdfs, s_final: torch.Tensor,
                           trans_final: torch.Tensor, radii) -> torch.Tensor:
    """Per-level, per-ray sums over the M_l proposal intervals of the
    anti-aliased interlevel loss, (L, R): clip(w_s - wp, 0)^2 / (wp + 1e-5),
    where w_s is the final distribution (edges s_final (R, K+1),
    transmittance trans_final (R, K)) blurred with half-width radii[l] and
    integrated over level l's cache edges caches_s[l] (R, M_l + 1), and wp
    = diff(caches_cdfs[l]).  Differentiable in caches_cdfs only (the rest
    is detached, as in the reference)."""
    radii = tuple(float(r) for r in radii)
    if torch.is_grad_enabled() and any(c.requires_grad for c in caches_cdfs):
        return _InterlevelLevels.apply(s_final, trans_final, radii, *caches_s, *caches_cdfs)
    return interlevel_loss_levels_ref(caches_s, caches_cdfs, s_final, trans_final, radii)[1]
