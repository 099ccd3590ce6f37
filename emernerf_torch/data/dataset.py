"""Host-side scene dataset (port of ``emernerf_tpu/data/dataset.py``).

Numpy split bookkeeping, joint timestamp normalization, the aabb,
whole-image eval rays, per-frame lidar rays and their camera visibility,
and the upload of the training scene to the device
(:meth:`SceneDataset.scene_tensors`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from emernerf_torch.data.scene import SceneTensors


class SceneDataset:
    """One driving scene: images + calibration + optional sky/dynamic masks,
    feature maps and lidar, with reference-compatible split logic."""

    def __init__(
        self,
        images: np.ndarray,  # (N, H, W, 3) float32 [0,1]
        c2w: np.ndarray,  # (N, 4, 4)
        intrinsics: np.ndarray,  # (N, 3, 3)
        frame_idx: np.ndarray,  # (N,) int  image -> frame/timestep index
        cam_ids: np.ndarray,  # (N,) int
        sky_masks: Optional[np.ndarray] = None,
        dynamic_masks: Optional[np.ndarray] = None,
        features: Optional[np.ndarray] = None,  # (N, Hf, Wf, C) float32
        lidar: Optional[Dict[str, np.ndarray]] = None,
        aabb: Optional[np.ndarray] = None,
        test_image_stride: int = 0,
        buffer_downscale: int = 16,
        buffer_ratio: float = 0.25,
    ):
        self.images = images
        self.c2w = c2w.astype(np.float32)
        self.intrinsics = intrinsics.astype(np.float32)
        self.frame_idx = np.asarray(frame_idx, np.int64)
        self.cam_ids = np.asarray(cam_ids, np.int32)
        self.sky_masks = sky_masks
        self.dynamic_masks = dynamic_masks
        self.features = features
        self.lidar = lidar
        self.buffer_downscale = buffer_downscale
        self.buffer_ratio = buffer_ratio
        self.num_frames = int(self.frame_idx.max()) + 1
        self.num_cams = int(self.cam_ids.max()) + 1

        # joint [0,1] timestamp normalization over image + lidar frames
        all_frames = self.frame_idx.astype(np.float64)
        if lidar is not None:
            all_frames = np.concatenate([all_frames, lidar["frame_idx"].astype(np.float64)])
        fmin, fmax = all_frames.min(), all_frames.max()
        denom = max(fmax - fmin, 1.0)
        self.normed_timestamps = ((self.frame_idx - fmin) / denom).astype(np.float32)
        if lidar is not None:
            self.lidar_normed_timestamps = (
                (lidar["frame_idx"] - fmin) / denom).astype(np.float32)

        # ---- splits: every Nth timestep -> test ----
        frames = np.arange(self.num_frames)
        test_frames = set(frames[::test_image_stride].tolist()) if test_image_stride > 0 else set()
        self.test_frames = np.asarray(sorted(test_frames), np.int64)
        is_test = np.isin(self.frame_idx, self.test_frames)
        self.train_indices = np.nonzero(~is_test)[0].astype(np.int32)
        self.test_indices = np.nonzero(is_test)[0].astype(np.int32)
        self.full_indices = np.arange(len(images), dtype=np.int32)

        # ---- aabb: given, else lidar percentiles, else camera-derived ----
        if aabb is not None:
            self.aabb = np.asarray(aabb, np.float32)
        elif lidar is not None:
            pts = lidar["origins"] + lidar["viewdirs"] * lidar["ranges"][:, None]
            sub = pts[:: max(len(pts) // 100000, 1)]
            amin = np.quantile(sub, 0.02, axis=0)
            amax = np.quantile(sub, 0.98, axis=0)
            amax[2] = max(amax[2], 20.0)
            self.aabb = np.concatenate([amin, amax]).astype(np.float32)
        else:
            centers = self.c2w[:, :3, 3]
            amin = centers.min(0) - np.array([40.0, 40.0, 5.0])
            amax = centers.max(0) + np.array([40.0, 40.0, 20.0])
            self.aabb = np.concatenate([amin, amax]).astype(np.float32)

    @property
    def image_hw(self):
        return self.images.shape[1], self.images.shape[2]

    @property
    def num_images(self) -> int:
        return len(self.images)

    @property
    def has_test_split(self) -> bool:
        return len(self.test_indices) > 0

    @property
    def num_train_timesteps(self) -> int:
        return len(set(self.frame_idx.tolist()) - set(self.test_frames.tolist()))

    @property
    def num_img_timesteps(self) -> int:
        return self.num_frames

    @property
    def unique_normalized_training_timestamps(self) -> np.ndarray:
        return np.unique(self.normed_timestamps[self.train_indices])

    @property
    def time_diff(self) -> float:
        return 1.0 / max(self.num_img_timesteps, 1)

    def scene_tensors(self, device=None) -> SceneTensors:
        """Upload the training scene; lidar rays restricted to training frames,
        the error buffer (all ones) present when ``buffer_ratio > 0``."""
        def dev(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

        h, w = self.image_hw
        lidar_kw = {}
        if self.lidar is not None:
            keep = ~np.isin(self.lidar["frame_idx"], self.test_frames)
            lidar_kw = dict(
                lidar_origins=dev(self.lidar["origins"][keep], torch.float32),
                lidar_viewdirs=dev(self.lidar["viewdirs"][keep], torch.float32),
                lidar_ranges=dev(self.lidar["ranges"][keep], torch.float32),
                lidar_normed_timestamps=dev(self.lidar_normed_timestamps[keep]),
            )
        error_map = None
        if self.buffer_ratio > 0:
            bd = self.buffer_downscale
            error_map = torch.ones((self.num_images, h // bd, w // bd), device=device)
        return SceneTensors(
            images=dev(self.images, torch.float32),
            c2w=dev(self.c2w),
            intrinsics=dev(self.intrinsics),
            normed_timestamps=dev(self.normed_timestamps),
            cam_ids=dev(self.cam_ids, torch.int64),
            train_indices=dev(self.train_indices, torch.int64),
            sky_masks=None if self.sky_masks is None else dev(self.sky_masks, torch.float32),
            features=None if self.features is None else dev(self.features, torch.float32),
            pixel_error_map=error_map,
            **lidar_kw,
        )

    def get_image_rays(self, img_idx: int, downscale: int = 1):
        """Whole-image eval rays: a rays dict of shape (H*W, ...) plus
        ground-truth maps."""
        h, w = self.image_hw
        hh, ww = h // downscale, w // downscale
        ys, xs = np.meshgrid(np.arange(hh) * downscale, np.arange(ww) * downscale,
                             indexing="ij")
        x = xs.reshape(-1).astype(np.float32)
        y = ys.reshape(-1).astype(np.float32)
        intr = self.intrinsics[img_idx].copy()
        cam_dirs = np.stack(
            [(x - intr[0, 2] + 0.5) / intr[0, 0],
             (y - intr[1, 2] + 0.5) / intr[1, 1],
             np.ones_like(x)],
            axis=-1,
        )
        c2w = self.c2w[img_idx]
        dirs = cam_dirs @ c2w[:3, :3].T
        dnorm = np.linalg.norm(dirs, axis=-1, keepdims=True)
        viewdirs = dirs / (dnorm + 1e-8)
        origins = np.broadcast_to(c2w[:3, 3], viewdirs.shape)
        n = len(x)
        rays = {
            "origins": origins.astype(np.float32),
            "viewdirs": viewdirs.astype(np.float32),
            "direction_norms": dnorm.astype(np.float32),
            "pixel_coords": np.stack([y / h, x / w], -1).astype(np.float32),
            "normed_timestamps": np.full(n, self.normed_timestamps[img_idx], np.float32),
            "img_idx": np.full(n, img_idx, np.int32),
            "cam_idx": np.full(n, self.cam_ids[img_idx], np.int32),
        }
        # the rendered pixels' rows and columns: where H or W is not a
        # multiple of the downscale, [::downscale] would keep one more
        # (the JAX package's maps then fail to broadcast against the render)
        rows, cols = slice(0, hh * downscale, downscale), slice(0, ww * downscale, downscale)
        gt = {"pixels": self.images[img_idx, rows, cols], "hw": (hh, ww)}
        if self.sky_masks is not None:
            gt["sky_masks"] = self.sky_masks[img_idx, rows, cols]
        if self.dynamic_masks is not None:
            gt["dynamic_masks"] = self.dynamic_masks[img_idx, rows, cols]
        if self.features is not None:
            # the feature map's nearest cell of each rendered pixel
            fh, fw = self.features.shape[1:3]
            fy = (np.arange(hh) * downscale * fh / h).astype(np.int64)
            fx = (np.arange(ww) * downscale * fw / w).astype(np.int64)
            gt["features"] = self.features[img_idx][np.ix_(fy, fx)]
        return rays, gt

    def get_valid_lidar_mask(self, frame: int, points: np.ndarray) -> np.ndarray:
        """Lidar-to-camera visibility: True where a world-space point projects
        inside at least one of the frame's images with positive depth."""
        h, w = self.image_hw
        valid = np.zeros(len(points), bool)
        for img_idx in np.nonzero(self.frame_idx == frame)[0]:
            w2c = np.linalg.inv(self.c2w[img_idx].astype(np.float64))
            cam_pts = points @ w2c[:3, :3].T + w2c[:3, 3]
            proj = cam_pts @ self.intrinsics[img_idx].astype(np.float64).T
            depth = proj[:, 2]
            uv = proj[:, :2] / (depth[:, None] + 1e-6)
            valid |= ((uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
                      & (depth > 0))
        return valid

    def get_lidar_render_rays(self, frame: int):
        """All lidar rays of one frame, for depth/flow eval."""
        if self.lidar is None:
            return None
        mask = self.lidar["frame_idx"] == frame
        return {
            "origins": self.lidar["origins"][mask],
            "viewdirs": self.lidar["viewdirs"][mask],
            "ranges": self.lidar["ranges"][mask],
            "normed_timestamps": self.lidar_normed_timestamps[mask],
        }
