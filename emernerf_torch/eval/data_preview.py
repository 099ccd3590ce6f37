"""Data-inspection video: GT rgb + projected lidar depth + lidar flow +
masks, rendered before training as the de-facto test that calibration / ray
/ flow conventions are right.

Port of ``emernerf_tpu/eval/data_preview.py``; counterpart of the original
EmerNeRF's ``render_data_videos`` (datasets/waymo.py) and its
--render_data_video CLI path.
"""

from __future__ import annotations

import logging
import os
from typing import List

import numpy as np

from emernerf_torch.eval.video import save_videos
from emernerf_torch.utils.visualization import depth_visualizer, scene_flow_to_rgb

logger = logging.getLogger("emernerf_torch")


def project_lidar_to_image(dataset, img_idx: int):
    """Project the frame's lidar returns into one camera image.
    Returns (depth_map (H,W), flow_map (H,W,3) or None)."""
    h, w = dataset.image_hw
    depth_map = np.zeros((h, w), np.float32)
    flow_map = None

    frame = int(dataset.frame_idx[img_idx])
    lidar = dataset.lidar
    if lidar is None:
        return depth_map, flow_map
    mask = lidar["frame_idx"] == frame
    if mask.sum() == 0:
        return depth_map, flow_map

    points = (
        lidar["origins"][mask]
        + lidar["viewdirs"][mask] * lidar["ranges"][mask][:, None]
    )
    c2w = dataset.c2w[img_idx]
    intr = dataset.intrinsics[img_idx]
    w2c_rot = c2w[:3, :3].T
    cam_pts = (points - c2w[:3, 3]) @ w2c_rot.T  # OpenCV cam coords
    z = cam_pts[:, 2]
    valid = z > 0.5
    u = intr[0, 0] * cam_pts[:, 0] / np.maximum(z, 1e-6) + intr[0, 2] - 0.5
    v = intr[1, 1] * cam_pts[:, 1] / np.maximum(z, 1e-6) + intr[1, 2] - 0.5
    ui, vi = np.round(u).astype(int), np.round(v).astype(int)
    valid &= (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)

    depth_map[vi[valid], ui[valid]] = z[valid]
    if "flows" in lidar:
        flow_map = np.zeros((h, w, 3), np.float32)
        flow_map[vi[valid], ui[valid]] = lidar["flows"][mask][valid]
    return depth_map, flow_map


def data_video_frames(dataset):
    """The data video's frames (gt rgb / lidar-depth / flow / mask rows per
    image) and the keys they hold."""
    frames: List[dict] = []
    for idx in dataset.full_indices:
        f = {"gt_rgb": dataset.images[idx]}
        depth_map, flow_map = project_lidar_to_image(dataset, int(idx))
        if depth_map.any():
            vis = depth_visualizer(
                np.where(depth_map > 0, depth_map, 1e3),
                (depth_map > 0).astype(np.float32),
            )
            # overlay sparse depth on dimmed rgb
            f["lidar_depth"] = np.where(
                (depth_map > 0)[..., None], vis, dataset.images[idx] * 0.5
            )
        if flow_map is not None and np.abs(flow_map).max() > 0:
            f["lidar_flow"] = scene_flow_to_rgb(flow_map, background="bright")
        if dataset.sky_masks is not None:
            f["gt_sky_mask"] = dataset.sky_masks[idx]
        if dataset.dynamic_masks is not None:
            f["gt_dynamic_mask"] = dataset.dynamic_masks[idx]
        frames.append(f)

    keys = [k for k in ("gt_rgb", "lidar_depth", "lidar_flow", "gt_sky_mask",
                        "gt_dynamic_mask") if k in frames[0]]
    return frames, keys


def render_data_video(dataset, save_pth: str, fps: int = 24,
                      save_seperate_video: bool = False) -> str:
    """Write the preview video of :func:`data_video_frames` (needs
    ``imageio``)."""
    frames, keys = data_video_frames(dataset)
    os.makedirs(os.path.dirname(save_pth) or ".", exist_ok=True)
    out = save_videos(
        frames, save_pth, keys=keys,
        num_timestamps=len(dataset.full_indices) // dataset.num_cams,
        fps=fps, num_cams=dataset.num_cams,
        save_seperate_video=save_seperate_video,
    )
    logger.info("Saved data preview video to %s", out)
    return out
