"""Bilinear sampling of the learnable positional-embedding map (port of
``emernerf_tpu/ops/interp.py``).

The semantics of ``torch.nn.functional.grid_sample`` (bilinear,
``align_corners=False``, zero padding), written out as the JAX function
computes them, so that the two packages agree bit for bit; the map is
(H, W, C), not grid_sample's (N, C, H, W).
"""

from __future__ import annotations

import torch


def grid_sample_2d(image_hwc: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Sample ``image_hwc`` (H, W, C) at normalized coordinates ``gx``
    (width axis) and ``gy`` (height axis) in [-1, 1], both (N,); returns
    (N, C).  Corners outside the map contribute zero."""
    h, w, _ = image_hwc.shape
    ix = ((gx + 1.0) * w - 1.0) / 2.0
    iy = ((gy + 1.0) * h - 1.0) / 2.0
    x0, y0 = torch.floor(ix), torch.floor(iy)
    fx = (ix - x0)[..., None].to(image_hwc.dtype)
    fy = (iy - y0)[..., None].to(image_hwc.dtype)
    x0i, y0i = x0.to(torch.int32), y0.to(torch.int32)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = image_hwc[yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        return vals * valid[..., None].to(image_hwc.dtype)

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)
