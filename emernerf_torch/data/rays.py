"""Camera ray generation (port of ``emernerf_tpu/data/rays.py``): OpenCV
intrinsics with the +0.5 pixel-center offset, directions rotated by the
c2w rotation and normalized; the pre-normalization norm is returned too."""

from __future__ import annotations

import torch


def get_rays(x, y, c2w, intrinsic):
    """x, y (N,) pixel coords; c2w (N, 4, 4); intrinsic (N, 3, 3) ->
    origins (N, 3), viewdirs (N, 3), direction_norm (N, 1)."""
    x, y = x.float(), y.float()
    camera_dirs = torch.stack(
        [(x - intrinsic[:, 0, 2] + 0.5) / intrinsic[:, 0, 0],
         (y - intrinsic[:, 1, 2] + 0.5) / intrinsic[:, 1, 1],
         torch.ones_like(x)], dim=-1)
    directions = (camera_dirs[:, None, :] * c2w[:, :3, :3]).sum(dim=-1)
    origins = c2w[:, :3, -1].expand(directions.shape)
    direction_norm = torch.sqrt((directions * directions).sum(dim=-1, keepdim=True))
    viewdirs = directions / (direction_norm + 1e-8)
    return origins, viewdirs, direction_norm
