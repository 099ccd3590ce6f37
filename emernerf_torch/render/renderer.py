"""Ray-batch rendering (port of ``emernerf_tpu/render/renderer.py``):
proposal sampling -> field query -> compositing, on one ray batch, in its
eval and its train form.

The train form adds the proposal caches (``requires_grad``), the
density-only lidar render (``is_lidar``) and top-K sample pruning: the
radiance field is queried at the K samples per ray that the last proposal
net ranks highest and its outputs are scattered back to (R, S) with zeros
elsewhere.  Random draws come in as tensors (``jitters``, ``topk_u``,
``agg_noise``); the caller makes them.  With ``remat`` the field query
alone runs under ``torch.utils.checkpoint``: its activations are dropped
after the forward and recomputed in the backward (the same grid kernels,
GEMMs and activations again); the sampling, the top-K scatter-back and the
compositing keep theirs.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from emernerf_torch.render.prop_sampler import PropCache, sample_along_rays
from emernerf_torch.render.volrend import composite_rays
from emernerf_torch.utils.trace import span

# per-ray keys the field consumes, expanded to (R, S)
_EXPAND_KEYS = ("normed_timestamps", "img_idx", "cam_idx")
# field outputs that are per ray, never scattered back over the samples
_PER_RAY_KEYS = frozenset({"rgb_sky", "dino_sky_feat", "dino_pe"})


class RenderResult(NamedTuple):
    out: Dict[str, torch.Tensor]  # the composited dict (with ``extras``)
    caches: List[PropCache]  # proposal caches (empty unless requires_grad)
    s_vals: torch.Tensor  # (R, S+1) final edges in s-space


def topk_sample_select(prop_fn, t_starts, t_ends, k: int, temp: float,
                       topk_u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Indices (R, K), ascending, of the K samples per ray with the highest
    proposal-estimated weight, perturbed by Gumbel noise of temperature
    ``temp`` made from the uniform draws ``topk_u`` (R, S).  Ties go to the
    lower index, as ``jax.lax.top_k`` breaks them."""
    with torch.no_grad():
        sigma_p = prop_fn(t_starts, t_ends)
        alpha = 1.0 - torch.exp(-sigma_p * (t_ends - t_starts))
        trans = torch.cat([torch.ones_like(alpha[..., :1]),
                           torch.cumprod(1.0 - alpha[..., :-1] + 1e-10, dim=-1)], dim=-1)
        scores = torch.log(trans * alpha + 1e-12)
        if temp > 0.0:
            if topk_u is None or topk_u.shape != scores.shape:
                raise ValueError(f"top-K selection with temperature needs topk_u "
                                 f"{tuple(scores.shape)}")
            gumbel = -torch.log(-torch.log(topk_u + 1e-12) + 1e-12)
            scores = scores + temp * gumbel
        idx = torch.sort(scores, dim=-1, descending=True, stable=True)[1][:, :k]
        return torch.sort(idx, dim=-1)[0]


def scatter_back(field_out: Dict[str, torch.Tensor], idx: torch.Tensor,
                 n_samples: int) -> Dict[str, torch.Tensor]:
    """Expand every per-sample (R, K, ...) field output to (R, S, ...) with
    zeros at the pruned samples; per-ray outputs pass through."""
    r, k = idx.shape

    def expand(x):
        if x.ndim < 2 or x.shape[:2] != (r, k):
            return x
        out = x.new_zeros((r, n_samples) + x.shape[2:])
        index = idx.reshape((r, k) + (1,) * (x.ndim - 2)).expand(x.shape)
        return out.scatter(1, index, x)

    return {key: (v if key in _PER_RAY_KEYS else expand(v)) for key, v in field_out.items()}


def render_ray_batch(
    model,
    prop_models: Sequence,
    rays: Dict[str, torch.Tensor],
    *,
    num_samples: int = 64,
    prop_samples: Sequence[int] = (128, 64),
    near_plane: float = 0.1,
    far_plane: float = 1000.0,
    sampling_type: str = "uniform_lindisp",
    jitters: Optional[Sequence[torch.Tensor]] = None,
    requires_grad: bool = False,
    return_decomposition: bool = False,
    is_lidar: bool = False,
    sample_topk: int = 0,
    sample_topk_temp: float = 0.0,
    topk_u: Optional[torch.Tensor] = None,
    agg_noise: Optional[torch.Tensor] = None,
    train: bool = False,
    remat: bool = False,
) -> RenderResult:
    """Render one ray batch.

    rays: "origins" (R,3), "viewdirs" (R,3) and optional per-ray metadata
    ("normed_timestamps", "img_idx", "cam_idx", "pixel_coords").
    ``jitters``: stratified-sampling draws (see sample_along_rays);
    ``topk_u``: (R, S) uniforms for the Gumbel top-K selection;
    ``agg_noise``: (R, S_q, 1) training-time aggregation noise of the field
    (S_q = sample_topk when pruning, else S); None is the eval's 1.
    ``train``: a training render (the field never interpolates the flow
    between training timesteps); ``remat``: recompute the field query in
    the backward instead of keeping its activations."""
    origins, viewdirs = rays["origins"], rays["viewdirs"]
    n_rays = origins.shape[0]

    def make_prop_fn(pm):
        def fn(t_starts, t_ends):
            mid = (t_starts + t_ends) / 2.0
            return pm(origins[:, None, :] + viewdirs[:, None, :] * mid[..., None])

        return fn

    with span("render"):
        with span("render.sampler"):
            prop_fns = [make_prop_fn(pm) for pm in prop_models]
            t_starts, t_ends, s_vals, caches = sample_along_rays(
                prop_fns, prop_samples, num_samples, n_rays, near_plane, far_plane,
                sampling_type=sampling_type, jitters=jitters, requires_grad=requires_grad,
                device=origins.device,
            )
            s = t_starts.shape[-1]
            mid = (t_starts + t_ends) / 2.0
            prune = bool(sample_topk) and 0 < sample_topk < s and bool(prop_fns)
            idx = None
            if prune:
                idx = topk_sample_select(prop_fns[-1], t_starts, t_ends, sample_topk,
                                         sample_topk_temp, topk_u)
                mid = torch.gather(mid, 1, idx)
        s_q = mid.shape[-1]
        with span("render.field"):
            positions = origins[:, None, :] + viewdirs[:, None, :] * mid[..., None]
            directions = viewdirs[:, None, :].expand(positions.shape)
            data = {}
            for k in _EXPAND_KEYS:
                if rays.get(k) is not None:
                    data[k] = rays[k][:, None].expand(n_rays, s_q)
            if rays.get("pixel_coords") is not None:
                data["pixel_coords"] = rays["pixel_coords"]

            def query(positions, directions, agg_noise):
                return model(positions, directions, data, return_density_only=is_lidar,
                             agg_noise=agg_noise, train=train)

            if remat:
                # every draw is an input, so the recomputation repeats the forward
                # exactly and no RNG state needs keeping; the non-reentrant variant
                # gives the parameters their gradients though no input requires one
                field_out = checkpoint(query, positions, directions, agg_noise,
                                       use_reentrant=False, preserve_rng_state=False)
            else:
                field_out = query(positions, directions, agg_noise)
            if prune:
                field_out = scatter_back(field_out, idx, s)
        with span("render.composite"):
            out = composite_rays(t_starts, t_ends, field_out,
                                 return_decomposition=return_decomposition)
    return RenderResult(out, caches, s_vals)
