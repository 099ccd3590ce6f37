"""Ray-batch rendering (port of ``emernerf_tpu/render/renderer.py``), eval form:
proposal sampling -> field query -> compositing, on one ray batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from emernerf_torch.render.prop_sampler import sample_along_rays
from emernerf_torch.render.volrend import composite_rays

# per-ray keys the field consumes, expanded to (R, S)
_EXPAND_KEYS = ("normed_timestamps", "img_idx", "cam_idx")


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
    return_decomposition: bool = False,
) -> Dict[str, torch.Tensor]:
    """Render one ray batch.

    rays: "origins" (R,3), "viewdirs" (R,3) and optional per-ray metadata
    ("normed_timestamps", "img_idx", "cam_idx", "pixel_coords").
    ``jitters``: optional stratified-sampling draws (see sample_along_rays).
    Returns the composited dict (with ``extras``)."""
    origins, viewdirs = rays["origins"], rays["viewdirs"]
    n_rays = origins.shape[0]

    def make_prop_fn(pm):
        def fn(t_starts, t_ends):
            mid = (t_starts + t_ends) / 2.0
            return pm(origins[:, None, :] + viewdirs[:, None, :] * mid[..., None])

        return fn

    t_starts, t_ends, _ = sample_along_rays(
        [make_prop_fn(pm) for pm in prop_models], prop_samples, num_samples,
        n_rays, near_plane, far_plane, sampling_type=sampling_type,
        jitters=jitters, device=origins.device,
    )
    s = t_starts.shape[-1]
    mid = (t_starts + t_ends) / 2.0
    positions = origins[:, None, :] + viewdirs[:, None, :] * mid[..., None]
    directions = viewdirs[:, None, :].expand(positions.shape)
    data = {}
    for k in _EXPAND_KEYS:
        if rays.get(k) is not None:
            data[k] = rays[k][:, None].expand(n_rays, s)
    if rays.get("pixel_coords") is not None:
        data["pixel_coords"] = rays["pixel_coords"]
    field_out = model(positions, directions, data)
    return composite_rays(t_starts, t_ends, field_out,
                          return_decomposition=return_decomposition)
