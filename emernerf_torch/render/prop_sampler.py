"""Proposal-network importance sampling (port of ``emernerf_tpu/render/prop_sampler.py``), eval form.

Sampling is detached, as in the reference.  Each proposal level inverts
the previous level's CDF (kernel K2), evaluates the proposal density at
the new intervals, and turns its transmittance (kernel K3) into the next
CDF.  The proposal caches for the interlevel loss come with training.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from emernerf_torch.ops.stepfuns import importance_sampling, transform_stot
from emernerf_torch.render.volrend import composite_along_rays


def sample_along_rays(
    prop_sigma_fns: Sequence[Callable],
    prop_samples: Sequence[int],
    num_samples: int,
    n_rays: int,
    near_plane: float,
    far_plane: float,
    sampling_type: str = "uniform_lindisp",
    jitters: Optional[Sequence[torch.Tensor]] = None,
    device=None,
):
    """Hierarchical proposal sampling.

    prop_sigma_fns: callables (t_starts, t_ends) -> densities (R, S).
    jitters: None (evenly spaced CDF positions, the eval form) or one (R, 1)
    jitter tensor per importance-sampling step (len(prop_samples) + 1),
    drawn by the caller in [-pad, pad] with pad = 1 / (2 * (n + 1)).
    Returns (t_starts, t_ends, s_vals_final)."""
    n_steps = len(prop_samples) + 1
    if jitters is not None and len(jitters) != n_steps:
        raise ValueError(f"need {n_steps} jitter tensors, got {len(jitters)}")
    jit = list(jitters) if jitters is not None else [None] * n_steps
    f32 = dict(dtype=torch.float32, device=device)
    cdfs = torch.cat([torch.zeros((n_rays, 1), **f32), torch.ones((n_rays, 1), **f32)], -1)
    s_vals = cdfs
    for level, (fn, n) in enumerate(zip(prop_sigma_fns, prop_samples)):
        s_vals = importance_sampling(s_vals, cdfs, n, jit[level])
        t_vals = transform_stot(sampling_type, s_vals, near_plane, far_plane)
        t_starts = t_vals[..., :-1].contiguous()
        t_ends = t_vals[..., 1:].contiguous()
        sigmas = fn(t_starts, t_ends)
        trans = composite_along_rays(t_starts, t_ends, sigmas[..., None].contiguous()).trans
        cdfs = 1.0 - torch.cat([trans[..., 0], torch.zeros_like(trans[:, :1, 0])], dim=-1)
    s_vals = importance_sampling(s_vals, cdfs, num_samples, jit[-1])
    t_vals = transform_stot(sampling_type, s_vals, near_plane, far_plane)
    return t_vals[..., :-1].contiguous(), t_vals[..., 1:].contiguous(), s_vals
