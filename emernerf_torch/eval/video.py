"""Render-output video/image writing: the port's own copy of
``emernerf_tpu/eval/video.py`` (``tests/test_torch_imports.py`` holds the
two to the same frames).

Counterpart of the original EmerNeRF's radiance_fields/video_utils.py:
frame dicts -> per-key or concatenated mp4/png via imageio, with depth
colormapping, flow coloring, and feature-PCA coloring applied per key.
``imageio`` is imported where a file is written, so that composing frames
needs only numpy.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from emernerf_torch.utils.visualization import (
    apply_pca_colors,
    depth_visualizer,
    get_robust_pca,
    scene_flow_to_rgb,
    to_uint8,
)

_DEPTH_KEYS = ("depth", "median_depth", "static_depth", "dynamic_depth")
_FLOW_KEYS = ("forward_flow", "backward_flow")
_FEAT_KEYS = ("dino_feat", "dino_pe", "dino_pe_free", "static_dino", "dynamic_dino")
_SCALAR_KEYS = ("opacity", "static_opacity", "dynamic_opacity", "shadow",
                "shadow_ratio", "gt_dynamic_mask", "gt_sky_mask")


def frame_to_rgb(key: str, value: np.ndarray,
                 opacity: Optional[np.ndarray] = None,
                 pca: Optional[tuple] = None) -> np.ndarray:
    """Convert one rendered map to an (H, W, 3) float image in [0,1]."""
    if key in _DEPTH_KEYS:
        return depth_visualizer(value, opacity)
    if key in _FLOW_KEYS:
        return scene_flow_to_rgb(value, background="bright")
    if key in _FEAT_KEYS:
        h, w = value.shape[:2]
        flat = value.reshape(-1, value.shape[-1])
        if pca is None:
            pca = get_robust_pca(flat)
        return apply_pca_colors(flat, *pca).reshape(h, w, 3)
    if key in _SCALAR_KEYS or value.ndim == 2:
        v = np.asarray(value, np.float32).squeeze()
        return np.stack([v, v, v], axis=-1)
    return np.asarray(value, np.float32)


def have_imageio() -> bool:
    """Whether ``imageio``, which writes the videos, is installed."""
    try:
        import imageio.v2  # noqa: F401
    except ImportError:
        return False
    return True


def compose_frame(frame: Dict[str, np.ndarray], keys: List[str]) -> np.ndarray:
    """Vertically stack the requested keys of one frame into a single image."""
    opacity = frame.get("opacity")
    rows = [frame_to_rgb(k, frame[k], opacity) for k in keys if k in frame]
    return to_uint8(np.concatenate(rows, axis=0))


def save_videos(
    frames: List[Dict[str, np.ndarray]],
    save_pth: str,
    keys: List[str],
    num_timestamps: int,
    fps: int = 24,
    num_cams: int = 1,
    save_seperate_video: bool = False,
) -> str:
    """Write an mp4 (or png when a single timestamp).  Multi-camera frames
    of the same timestep are concatenated horizontally, keys vertically
    (video_utils.py:507-627).  Needs ``imageio``."""
    os.makedirs(os.path.dirname(save_pth) or ".", exist_ok=True)
    if save_seperate_video:
        root, ext = os.path.splitext(save_pth)
        for k in keys:
            if k in frames[0]:
                _write_video(frames, f"{root}_{k}{ext}", [k],
                             num_timestamps, fps, num_cams)
        return save_pth
    return _write_video(frames, save_pth, keys, num_timestamps, fps, num_cams)


def _write_video(frames, save_pth, keys, num_timestamps, fps, num_cams):
    import imageio.v2 as imageio

    composed = []
    for t in range(num_timestamps):
        per_cam = [
            compose_frame(frames[t * num_cams + c], keys)
            for c in range(num_cams)
            if t * num_cams + c < len(frames)
        ]
        composed.append(np.concatenate(per_cam, axis=1))
    if num_timestamps == 1:
        save_pth = save_pth.replace(".mp4", ".png")
        imageio.imwrite(save_pth, composed[0])
    else:
        try:
            imageio.mimwrite(save_pth, composed, fps=fps)
        except (ValueError, ImportError):
            # no ffmpeg backend in this environment: fall back to gif
            save_pth = save_pth.replace(".mp4", ".gif")
            imageio.mimwrite(save_pth, composed, duration=1000.0 / fps)
    return save_pth
