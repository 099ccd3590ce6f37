"""Proposal-network importance sampling and the interlevel loss (port of
``emernerf_tpu/render/prop_sampler.py``).

Sampling is detached, as in the reference.  Each proposal level inverts
the previous level's CDF (kernel K2), evaluates the proposal density at
the new intervals, and turns its transmittance (kernel K3) into the next
CDF.  With ``requires_grad`` the proposal queries keep their graph and
each level's CDF is cached for the interlevel loss (kernel K5); without
it they run under ``torch.no_grad()``.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from emernerf_torch.ops.stepfuns import (
    importance_sampling,
    interlevel_loss_levels,
    pdf_outer_loss,
    transform_stot,
)
from emernerf_torch.render.volrend import composite_along_rays


class PropCache(NamedTuple):
    """One proposal level's outputs for the interlevel loss."""

    s_vals: torch.Tensor  # (R, K+1) interval edges in s-space (detached)
    cdfs: torch.Tensor  # (R, K+1) CDF at those edges (grad flows to the propnet)
    level: int


def sample_along_rays(
    prop_sigma_fns: Sequence[Callable],
    prop_samples: Sequence[int],
    num_samples: int,
    n_rays: int,
    near_plane: float,
    far_plane: float,
    sampling_type: str = "uniform_lindisp",
    jitters: Optional[Sequence[torch.Tensor]] = None,
    requires_grad: bool = False,
    device=None,
):
    """Hierarchical proposal sampling.

    prop_sigma_fns: callables (t_starts, t_ends) -> densities (R, S).
    jitters: None (evenly spaced CDF positions, the eval form) or one (R, 1)
    jitter tensor per importance-sampling step (len(prop_samples) + 1),
    drawn by the caller in [-pad, pad] with pad = 1 / (2 * (n + 1)).
    Returns (t_starts, t_ends, s_vals_final, caches); caches is empty unless
    ``requires_grad``."""
    n_steps = len(prop_samples) + 1
    if jitters is not None and len(jitters) != n_steps:
        raise ValueError(f"need {n_steps} jitter tensors, got {len(jitters)}")
    jit = list(jitters) if jitters is not None else [None] * n_steps
    f32 = dict(dtype=torch.float32, device=device)
    cdfs = torch.cat([torch.zeros((n_rays, 1), **f32), torch.ones((n_rays, 1), **f32)], -1)
    s_vals = cdfs
    caches: List[PropCache] = []
    for level, (fn, n) in enumerate(zip(prop_sigma_fns, prop_samples)):
        s_vals = importance_sampling(s_vals, cdfs, n, jit[level])
        t_vals = transform_stot(sampling_type, s_vals, near_plane, far_plane)
        t_starts = t_vals[..., :-1].contiguous()
        t_ends = t_vals[..., 1:].contiguous()
        with torch.set_grad_enabled(requires_grad and torch.is_grad_enabled()):
            sigmas = fn(t_starts, t_ends)
            trans = composite_along_rays(t_starts, t_ends,
                                         sigmas[..., None].contiguous()).trans
            cdfs_grad = 1.0 - torch.cat([trans[..., 0], torch.zeros_like(trans[:, :1, 0])],
                                        dim=-1)
        if requires_grad:
            caches.append(PropCache(s_vals, cdfs_grad, level))
        # sampling of the next level never backprops through the CDF
        cdfs = cdfs_grad.detach()
    s_vals = importance_sampling(s_vals, cdfs, num_samples, jit[-1])
    t_vals = transform_stot(sampling_type, s_vals, near_plane, far_plane)
    return t_vals[..., :-1].contiguous(), t_vals[..., 1:].contiguous(), s_vals, caches


@functools.lru_cache(maxsize=None)
def _level_sizes(sizes, device) -> torch.Tensor:
    """The element counts R * M_l of each level's loss terms, as float32 on
    ``device``: built once per (sizes, device), read-only."""
    return torch.tensor(sizes, dtype=torch.float32, device=device)


def compute_prop_loss(
    caches: Sequence[PropCache],
    s_vals_final: torch.Tensor,
    trans_final: torch.Tensor,
    enable_anti_aliasing: bool = True,
    pulse_widths: Sequence[float] = (0.03, 0.003),
    loss_scaler: float = 1.0,
) -> torch.Tensor:
    """Interlevel loss supervising the proposal networks with the final
    render's (detached) distribution: the zip-NeRF blurred-stepfun loss (one
    K5 launch for all cache levels, each at its level's pulse width) or,
    without anti-aliasing, the mip-NeRF 360 outer-envelope loss."""
    if not caches:
        return s_vals_final.new_zeros(())
    trans_final = trans_final.detach().contiguous()
    s_vals_final = s_vals_final.detach().contiguous()
    if enable_anti_aliasing:
        per_ray = interlevel_loss_levels(
            [cache.s_vals.contiguous() for cache in caches],
            [cache.cdfs.contiguous() for cache in caches], s_vals_final, trans_final,
            [pulse_widths[cache.level] for cache in caches])
        # each level's mean over its R x M_l terms, summed over the levels
        sizes = tuple(per_ray.shape[1] * (cache.cdfs.shape[1] - 1) for cache in caches)
        loss = (per_ray.sum(dim=1) / _level_sizes(sizes, per_ray.device)).sum()
    else:
        cdfs = 1.0 - torch.cat([trans_final, torch.zeros_like(trans_final[..., :1])], -1)
        loss = s_vals_final.new_zeros(())
        for cache in caches:
            loss = loss + pdf_outer_loss(s_vals_final, cdfs, cache.s_vals, cache.cdfs).mean()
    return loss * loss_scaler


def proposal_requires_grad_schedule(target: float = 5.0, num_steps: int = 1000):
    """Host-side stateful schedule deciding when proposal nets get gradients.
    Called once per render (twice per train iteration when lidar supervision
    is on), as in the reference."""
    state = {"since": 0}

    def fn(step: int) -> bool:
        target_since = min(step / num_steps, 1.0) * target
        requires = state["since"] > target_since
        if requires:
            state["since"] = 0
        state["since"] += 1
        return requires

    return fn
