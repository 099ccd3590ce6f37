"""Waymo-NOTR scene loading from the preprocessed on-disk layout (port of
``emernerf_tpu/data/waymo.py``, numpy only).

The layout::

  images/{t:03d}_{cam}.jpg            sky_masks/{t:03d}_{cam}.png
  dynamic_masks/{t:03d}_{cam}.png     <feature_model>/{t:03d}_{cam}.npy
  intrinsics/{cam}.txt  ([fx, fy, cx, cy, k1, k2, p1, p2, k3])
  extrinsics/{cam}.txt  (4x4 cam->ego)
  ego_pose/{t:03d}.txt  (4x4 ego->world)
  lidar/{t:03d}.bin     (float32 Nx14: origin 3, point 3, flow 3,
                         flow_class 1, ground 1, intensity 1, elongation 1,
                         laser_id 1)
  occ3d/{t:03d}.npz, occ3d/{t:03d}_04.npz  (Occ3D annotations, eval/occ.py)

The reference's semantics: the camera subsets ([0] / [1,0,2] /
[3,1,0,2,4]), intrinsics rescaled to ``load_size``, the OpenCV->Waymo axis
change, ego poses normalized to the first kept frame, the top-lidar and
range filters, velocities divided by 10 into per-scan flows, and the
feature maps (fp16 on disk) PCA-reduced to ``target_feature_dim`` and
min-max normalized.  Where a scene lacks feature maps, the loader extracts
those of the loaded frames and cameras on ``device`` (the card unless the
caller asks for the CPU) with ``emernerf_torch/tools/extract_features.py``,
unless ``skip_feature_extraction`` is set, where it raises.  The scenes
themselves come from ``python -m emernerf_torch.tools.preprocess``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
from PIL import Image

from emernerf_torch.config import ConfigNode
from emernerf_torch.data.dataset import SceneDataset

logger = logging.getLogger("emernerf_torch")

# original sensor resolutions per camera (front x3 are 1280x1920, sides 884x1920)
ORIGINAL_SIZE = [[1280, 1920], [1280, 1920], [1280, 1920], [884, 1920], [884, 1920]]

# OpenCV cam (x right, y down, z forward) -> Waymo (x front, y left, z up)
OPENCV2DATASET = np.array(
    [[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]], dtype=np.float64
)

CAMERA_LISTS = {1: [0], 3: [1, 0, 2], 5: [3, 1, 0, 2, 4]}


def _load_image(path: str, hw) -> np.ndarray:
    img = Image.open(path).convert("RGB").resize((hw[1], hw[0]), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def _load_mask(path: str, hw) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    img = Image.open(path).convert("L").resize((hw[1], hw[0]), Image.NEAREST)
    return (np.asarray(img, np.float32) > 0).astype(np.float32)


def reduce_features_pca(feats: np.ndarray, target_dim: int, sample: int = 100_000,
                        seed: int = 0):
    """PCA-reduce per-pixel features (N, Hf, Wf, C) to ``target_dim`` and
    min-max normalize to [0, 1].  Returns (reduced, reduction_mat, fmin,
    fmax)."""
    n, hf, wf, c = feats.shape
    flat = feats.reshape(-1, c)
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(flat), size=min(sample, len(flat)), replace=False)
    sub = flat[idx].astype(np.float64)
    sub = sub - sub.mean(0)
    _, _, vt = np.linalg.svd(sub, full_matrices=False)
    mat = vt[:target_dim].T.astype(np.float32)  # (C, target)
    reduced = flat @ mat
    fmin, fmax = reduced.min(0), reduced.max(0)
    reduced = (reduced - fmin) / np.maximum(fmax - fmin, 1e-12)
    return reduced.reshape(n, hf, wf, target_dim), mat, fmin, fmax


def _extract_missing_features(data_path, pix, start, end, cam_list, device) -> None:
    """On-demand DINO feature extraction where maps are missing (the
    reference's pixel_source.py:288-382): the maps of frames [start, end)
    of every camera of ``cam_list``, on ``device``."""
    if pix.get("skip_feature_extraction", False):
        raise FileNotFoundError(
            f"features missing under {data_path}/{pix.feature_model_type} "
            "and skip_feature_extraction=True; run "
            "emernerf_torch.tools.extract_features first")
    from emernerf_torch.tools.extract_features import extract_and_save_features

    imgs, feats = [], []
    for t in range(start, end):
        for cam in cam_list:
            imgs.append(os.path.join(data_path, "images", f"{t:03d}_{cam}.jpg"))
            feats.append(os.path.join(data_path, pix.feature_model_type, f"{t:03d}_{cam}.npy"))
    logger.info("Extracting %d missing feature maps...", len(imgs))
    extract_and_save_features(
        imgs, feats, model_type=pix.feature_model_type,
        extraction_size=tuple(pix.feature_extraction_size),
        device=device, stride=pix.get("feature_extraction_stride", 7))


def load_waymo_dataset(cfg: ConfigNode, device="cuda") -> SceneDataset:
    """The preprocessed scene ``data.scene_idx`` under ``data.data_root``;
    missing feature maps are extracted on ``device``."""
    data_cfg = cfg.data
    pix = data_cfg.pixel_source
    data_path = os.path.join(data_cfg.data_root, f"{data_cfg.scene_idx:03d}")
    if not os.path.isdir(data_path):
        raise FileNotFoundError(f"Waymo scene directory not found: {data_path}")

    # ---- timestep range ----
    start = data_cfg.start_timestep
    end = data_cfg.end_timestep
    if end == -1:
        end = len(os.listdir(os.path.join(data_path, "ego_pose")))
    cam_list = CAMERA_LISTS[pix.num_cams]
    hw = tuple(pix.load_size)

    # ---- calibration ----
    intrinsics_per_cam, cam_to_egos = {}, {}
    for cam in cam_list:
        vals = np.loadtxt(os.path.join(data_path, "intrinsics", f"{cam}.txt"))
        fx, fy, cx, cy = vals[0], vals[1], vals[2], vals[3]
        sy = hw[0] / ORIGINAL_SIZE[cam][0]
        sx = hw[1] / ORIGINAL_SIZE[cam][1]
        intrinsics_per_cam[cam] = np.array(
            [[fx * sx, 0, cx * sx], [0, fy * sy, cy * sy], [0, 0, 1]], dtype=np.float64)
        cam_to_ego = np.loadtxt(os.path.join(data_path, "extrinsics", f"{cam}.txt"))
        cam_to_egos[cam] = cam_to_ego @ OPENCV2DATASET

    ego_start_inv = np.linalg.inv(
        np.loadtxt(os.path.join(data_path, "ego_pose", f"{start:03d}.txt")))

    images, sky_masks, dynamic_masks, features = [], [], [], []
    c2ws, intrs, cam_ids, frame_idx, ego_to_worlds = [], [], [], [], []
    feat_dir = os.path.join(data_path, pix.feature_model_type)

    for t in range(start, end):
        ego_to_world = ego_start_inv @ np.loadtxt(
            os.path.join(data_path, "ego_pose", f"{t:03d}.txt"))
        ego_to_worlds.append(ego_to_world)
        for cam in cam_list:
            name = f"{t:03d}_{cam}"
            if pix.load_rgb:
                images.append(_load_image(os.path.join(data_path, "images", f"{name}.jpg"), hw))
            if pix.load_sky_mask:
                sky_masks.append(_load_mask(os.path.join(data_path, "sky_masks", f"{name}.png"),
                                            hw))
            if pix.load_dynamic_mask:
                dynamic_masks.append(
                    _load_mask(os.path.join(data_path, "dynamic_masks", f"{name}.png"), hw))
            if pix.load_features:
                feat_path = os.path.join(feat_dir, f"{name}.npy")
                if not os.path.exists(feat_path):
                    _extract_missing_features(data_path, pix, start, end, cam_list, device)
                features.append(np.load(feat_path).astype(np.float32))
            c2ws.append(ego_to_world @ cam_to_egos[cam])
            intrs.append(intrinsics_per_cam[cam])
            cam_ids.append(cam_list.index(cam))
            frame_idx.append(t - start)

    images = np.stack(images).astype(np.float32) if images else None
    sky = (np.stack(sky_masks).astype(np.float32)
           if sky_masks and sky_masks[0] is not None else None)
    dyn = (np.stack(dynamic_masks).astype(np.float32)
           if dynamic_masks and dynamic_masks[0] is not None else None)
    feats, feat_pca = None, None
    if features:
        feats = np.stack(features)
        if pix.target_feature_dim:
            feats, mat, fmin, fmax = reduce_features_pca(feats, pix.target_feature_dim)
            feat_pca = (mat, fmin, fmax)

    # ---- lidar ----
    lidar = None
    if data_cfg.lidar_source.load_lidar:
        lcfg = data_cfg.lidar_source
        lo, ld, lr, lt, lflow, lflow_cls, lground = [], [], [], [], [], [], []
        for t in range(start, end):
            path = os.path.join(data_path, "lidar", f"{t:03d}.bin")
            if not os.path.exists(path):
                continue
            info = np.memmap(path, dtype=np.float32, mode="r").reshape(-1, 14)
            if lcfg.only_use_top_lidar:
                info = info[info[:, 13] == 0]
            mask = np.ones(len(info), bool)
            if lcfg.truncated_max_range is not None:
                mask &= info[:, 3] < lcfg.truncated_max_range
            if lcfg.truncated_min_range is not None:
                mask &= info[:, 3] > lcfg.truncated_min_range
            info = info[mask]

            l2w = ego_to_worlds[t - start]  # lidar frame == ego frame on disk
            origins = info[:, :3] @ l2w[:3, :3].T + l2w[:3, 3]
            points = info[:, 3:6] @ l2w[:3, :3].T + l2w[:3, 3]
            flows = info[:, 6:9] @ l2w[:3, :3].T
            dirs = points - origins
            ranges = np.linalg.norm(dirs, axis=-1)
            dirs = dirs / np.maximum(ranges[:, None], 1e-8)
            lo.append(origins.astype(np.float32))
            ld.append(dirs.astype(np.float32))
            lr.append(ranges.astype(np.float32))
            lt.append(np.full(len(info), t - start, np.int64))
            # velocities (m/s) -> per-scan displacement at 10 Hz
            lflow.append((flows / 10.0).astype(np.float32))
            lflow_cls.append(info[:, 9].astype(np.int64))
            lground.append(info[:, 10].astype(bool))
        lidar = dict(origins=np.concatenate(lo), viewdirs=np.concatenate(ld),
                     ranges=np.concatenate(lr), frame_idx=np.concatenate(lt),
                     flows=np.concatenate(lflow), flow_classes=np.concatenate(lflow_cls),
                     ground=np.concatenate(lground))
        logger.info("Loaded %d lidar rays", len(lidar["ranges"]))

    dataset = SceneDataset(
        images=images,
        c2w=np.stack(c2ws),
        intrinsics=np.stack(intrs),
        frame_idx=np.asarray(frame_idx),
        cam_ids=np.asarray(cam_ids),
        sky_masks=sky,
        dynamic_masks=dyn,
        features=feats,
        lidar=lidar,
        test_image_stride=pix.test_image_stride,
        buffer_downscale=pix.sampler.buffer_downscale,
        buffer_ratio=pix.sampler.buffer_ratio,
    )
    dataset.feat_pca = feat_pca
    dataset.data_path = data_path
    # per-frame ego->world poses: Occ3D voxel centers are annotated in the
    # ego frame and lifted to world by them (eval/occ.py)
    dataset.ego_to_worlds = np.stack(ego_to_worlds)
    dataset.occ_voxel_size = float(data_cfg.get("occ_source", {}).get("voxel_size", 0.1))
    return dataset
