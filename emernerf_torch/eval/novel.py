"""Novel-trajectory rendering (port of ``emernerf_tpu/eval/novel.py``).

The original EmerNeRF leaves this as a TODO (config key
``render.render_novel_trajectory``); this implements it: generate a novel
camera path by SE(3)-interpolating the front camera's training trajectory
(temporal upsampling) with an optional smooth lateral offset sweep, then
render rgb/depth along it.  Timestamps are interpolated jointly so dynamic
scenes replay at the upsampled rate.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from emernerf_torch.data.utils import interpolate_matrices


def generate_novel_trajectory(
    dataset,
    cam_id: int = 0,
    upsample: int = 2,
    lateral_amplitude: float = 1.0,
) -> List[Dict[str, np.ndarray]]:
    """Per-frame novel cameras: temporally-upsampled front-cam poses with a
    sinusoidal lateral (camera-x) offset sweep.

    Returns a list of dicts {c2w, intrinsics, normed_timestamp}."""
    idx = np.nonzero(dataset.cam_ids == cam_id)[0]
    if len(idx) < 2:
        raise ValueError("need at least two frames of the chosen camera")
    c2ws = dataset.c2w[idx].astype(np.float64)
    intr = dataset.intrinsics[idx[0]]
    times = dataset.normed_timestamps[idx].astype(np.float64)

    frames = []
    n = len(idx)
    total = (n - 1) * upsample + 1
    for k in range(total):
        f = k / upsample
        i = min(int(np.floor(f)), n - 2)
        alpha = f - i
        c2w = interpolate_matrices(c2ws[i], c2ws[i + 1], alpha)
        # smooth lateral sweep in the camera's x axis
        phase = 2.0 * np.pi * k / max(total - 1, 1)
        offset = lateral_amplitude * np.sin(phase)
        c2w = c2w.copy()
        c2w[:3, 3] += c2w[:3, 0] * offset
        t = (1 - alpha) * times[i] + alpha * times[i + 1]
        frames.append(
            dict(
                c2w=c2w.astype(np.float32),
                intrinsics=np.asarray(intr, np.float32),
                normed_timestamp=np.float32(t),
            )
        )
    return frames


def _rays_for_camera(c2w, intrinsics, hw, normed_timestamp, cam_id=0):
    h, w = hw
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x = xs.reshape(-1).astype(np.float32)
    y = ys.reshape(-1).astype(np.float32)
    cam_dirs = np.stack(
        [
            (x - intrinsics[0, 2] + 0.5) / intrinsics[0, 0],
            (y - intrinsics[1, 2] + 0.5) / intrinsics[1, 1],
            np.ones_like(x),
        ],
        axis=-1,
    )
    dirs = cam_dirs @ c2w[:3, :3].T
    dnorm = np.linalg.norm(dirs, axis=-1, keepdims=True)
    viewdirs = dirs / (dnorm + 1e-8)
    n = len(x)
    return {
        "origins": np.broadcast_to(c2w[:3, 3], viewdirs.shape).astype(
            np.float32
        ),
        "viewdirs": viewdirs.astype(np.float32),
        "direction_norms": dnorm.astype(np.float32),
        "pixel_coords": np.stack([y / h, x / w], -1).astype(np.float32),
        "normed_timestamps": np.full(n, normed_timestamp, np.float32),
        "cam_idx": np.full(n, cam_id, np.int32),
    }


def render_novel_trajectory(
    renderer,
    dataset,
    downscale: int = 2,
    upsample: int = 2,
    lateral_amplitude: float = 1.0,
    max_frames: Optional[int] = None,
) -> List[Dict[str, np.ndarray]]:
    """Render rgb/depth maps along the generated novel path through the
    port's ``ImageRenderer``."""
    cams = generate_novel_trajectory(
        dataset, upsample=upsample, lateral_amplitude=lateral_amplitude
    )
    if max_frames:
        cams = cams[:max_frames]
    h, w = dataset.image_hw
    hw = (h // downscale, w // downscale)
    frames = []
    for cam in cams:
        intr = cam["intrinsics"].copy()
        intr[:2] /= downscale
        rays = _rays_for_camera(
            cam["c2w"], intr, hw, cam["normed_timestamp"]
        )
        frames.append(renderer.render_image(rays, hw))
    return frames
