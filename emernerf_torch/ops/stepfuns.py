"""Step-function math for proposal sampling (port of ``emernerf_tpu/ops/stepfuns.py``).

The s<->t ray warps (with the piecewise linear/inverse split at 200 m),
transmittance from density, and inverse-CDF importance sampling on dense
(n_rays, n_edges) tensors.  ``importance_sampling`` is the wrapper around
the K2 CUDA kernel (``kernels/csrc/importance_sampling.cu``);
``importance_sampling_ref`` is its plain version.  The interlevel-loss
pieces come with training.
"""

from __future__ import annotations

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
    u = sample_positions(n_intervals + 1, s_vals.device)[None, :]
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
    lib = kernels.load()
    r, k1 = s_vals.shape
    m = n_intervals + 1
    u_base = sample_positions(m, s_vals.device)
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
