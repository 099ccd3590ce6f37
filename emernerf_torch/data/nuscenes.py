"""nuScenes scene loading (port of ``emernerf_tpu/data/nuscenes.py``, numpy
only), with the reference's semantics:

  * **meta caching**: the devkit token walk (each camera's sample_data
    chain with one ego pose per image, and the lidar chain) is written to
    ``{data_root}/emernerf_metas/scene_XXX_{camera,lidar}.json``, so that
    later runs read the metas and never walk the tables;
  * **asynchronous cameras**: every camera keeps its own ego pose per
    image; the scene length is the shortest chain among the cameras used;
  * **scene_fraction**: the lidar range covers the same fraction of its
    own (longer) chain as the cameras cover of theirs;
  * ``.pcd.bin`` sweeps read as 5 float32 per point, truncated on x;
  * sky-mask and feature paths by directory substitution (samples ->
    samples_sky_mask / samples_<feature_model>); no dynamic masks, no
    flow labels, no test split.

The walk uses ``nuscenes-devkit`` where it is installed, else the
table reader ``emernerf_torch/data/nuscenes_devkit_lite.py``; loading
from cached metas needs neither.  Feature maps are PCA-reduced by the
port's own ``reduce_features_pca`` (``emernerf_torch/data/waymo.py``).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional

import numpy as np

from emernerf_torch.config import ConfigNode
from emernerf_torch.data.dataset import SceneDataset
from emernerf_torch.data.waymo import reduce_features_pca

logger = logging.getLogger("emernerf_torch")

CAMERA_LISTS = {
    1: ["CAM_FRONT"],
    3: ["CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT"],
    6: [
        "CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
        "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT",
    ],
}

ALL_CAMERAS = CAMERA_LISTS[6]

# nuScenes camera sensor frames already use the OpenCV convention
# (x right, y down, z forward), so this is the identity
OPENCV2DATASET = np.eye(4, dtype=np.float64)


def _quat_to_mat(q):
    w, x, y, z = q
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _pose_to_mat(record) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = _quat_to_mat(record["rotation"])
    m[:3, 3] = record["translation"]
    return m


# --------------------------------------------------------------------- #
# meta construction (devkit) + caching
# --------------------------------------------------------------------- #


def build_camera_meta(nusc, scene) -> Dict:
    """Walk every camera's sample_data chain (asynchronous shutters: one
    ego pose per image)."""
    meta = {
        cam: {
            "timestamp": [], "filepath": [], "ego_pose": [],
            "cam_id": [], "extrinsics": [], "intrinsics": [],
        }
        for cam in ALL_CAMERAS
    }
    first_sample = nusc.get("sample", scene["first_sample_token"])
    for i, cam in enumerate(ALL_CAMERAS):
        token = first_sample["data"][cam]
        while token:
            sd = nusc.get("sample_data", token)
            calib = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
            ego = nusc.get("ego_pose", sd["ego_pose_token"])
            m = meta[cam]
            m["cam_id"].append(i)
            m["timestamp"].append(sd["timestamp"])
            m["filepath"].append(sd["filename"])
            m["intrinsics"].append(
                np.asarray(calib["camera_intrinsic"]).tolist()
            )
            m["extrinsics"].append(_pose_to_mat(calib).tolist())
            m["ego_pose"].append(_pose_to_mat(ego).tolist())
            token = sd["next"]
    return meta


def build_lidar_meta(nusc, scene) -> Dict:
    """The LIDAR_TOP sample_data chain, sweeps included."""
    meta = {"timestamp": [], "filepath": [], "extrinsics": [], "ego_pose": []}
    first_sample = nusc.get("sample", scene["first_sample_token"])
    token = first_sample["data"]["LIDAR_TOP"]
    while token:
        sd = nusc.get("sample_data", token)
        calib = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        ego = nusc.get("ego_pose", sd["ego_pose_token"])
        meta["timestamp"].append(sd["timestamp"])
        meta["filepath"].append(sd["filename"])
        meta["extrinsics"].append(_pose_to_mat(calib).tolist())
        meta["ego_pose"].append(_pose_to_mat(ego).tolist())
        token = sd["next"]
    return meta


def _meta_paths(data_root: str, scene_idx: int):
    d = os.path.join(data_root, "emernerf_metas")
    return (
        os.path.join(d, f"scene_{scene_idx:03d}_camera.json"),
        os.path.join(d, f"scene_{scene_idx:03d}_lidar.json"),
    )


def create_or_load_metas(cfg: ConfigNode):
    """Load cached metas, or build + cache them via the devkit."""
    data_cfg = cfg.data
    cam_path, lidar_path = _meta_paths(data_cfg.data_root, data_cfg.scene_idx)
    if os.path.exists(cam_path) and os.path.exists(lidar_path):
        with open(cam_path) as f:
            cam_meta = json.load(f)
        with open(lidar_path) as f:
            lidar_meta = json.load(f)
        logger.info("Loaded cached nuScenes metas from %s", cam_path)
        return cam_meta, lidar_meta

    try:
        from nuscenes.nuscenes import NuScenes
    except ImportError:
        # dependency-free reader of the same on-disk table layout
        from emernerf_torch.data.nuscenes_devkit_lite import (
            NuScenesLite as NuScenes,
        )

        logger.info(
            "nuscenes-devkit not installed; using the built-in table reader"
        )
    nusc = NuScenes(
        version=data_cfg.get("nuscenes_version", "v1.0-trainval"),
        dataroot=data_cfg.data_root,
        verbose=False,
    )
    scene = nusc.scene[data_cfg.scene_idx]
    cam_meta = build_camera_meta(nusc, scene)
    lidar_meta = build_lidar_meta(nusc, scene)
    os.makedirs(os.path.dirname(cam_path), exist_ok=True)
    with open(cam_path, "w") as f:
        json.dump(cam_meta, f)
    with open(lidar_path, "w") as f:
        json.dump(lidar_meta, f)
    logger.info("Cached nuScenes metas at %s", cam_path)
    return cam_meta, lidar_meta


# --------------------------------------------------------------------- #
# dataset loading from metas (devkit-free)
# --------------------------------------------------------------------- #


def _sky_mask_path(img_path: str) -> str:
    return (
        img_path.replace("samples", "samples_sky_mask")
        .replace("sweeps", "sweeps_sky_mask")
        .replace(".jpg", ".png")
    )


def _feature_path(img_path: str, model_type: str) -> str:
    return (
        img_path.replace("samples", f"samples_{model_type}")
        .replace("sweeps", f"sweeps_{model_type}")
        .replace(".jpg", ".npy")
    )


def load_nuscenes_from_meta(cam_meta: Dict, lidar_meta: Optional[Dict],
                            cfg: ConfigNode) -> SceneDataset:
    from PIL import Image

    data_cfg = cfg.data
    pix = data_cfg.pixel_source
    root = data_cfg.data_root
    cam_list = CAMERA_LISTS[pix.num_cams]
    hw = tuple(pix.load_size)

    # minimum shared scene length across the used cameras
    num_timestamps = min(len(cam_meta[c]["timestamp"]) for c in cam_list)
    start = data_cfg.start_timestep
    end = data_cfg.end_timestep
    end = num_timestamps - 1 if end == -1 else min(end, num_timestamps - 1)
    end += 1  # include the last timestep
    start = min(start, end - 1)
    scene_fraction = (end - start) / num_timestamps

    images, sky_masks, features = [], [], []
    c2ws, intrs, cam_ids, frame_idx = [], [], [], []
    # world origin = CAM_FRONT's ego pose at the start timestep
    world_ref = np.linalg.inv(
        np.asarray(cam_meta["CAM_FRONT"]["ego_pose"][start], np.float64)
    )
    for t in range(start, end):
        for ci, cam in enumerate(cam_list):
            m = cam_meta[cam]
            ego_to_world = np.asarray(m["ego_pose"][t], np.float64)
            cam_to_ego = np.asarray(m["extrinsics"][t], np.float64)
            c2w = world_ref @ ego_to_world @ cam_to_ego @ OPENCV2DATASET

            img_path = os.path.join(root, m["filepath"][t])
            img = Image.open(img_path).convert("RGB")
            ow, oh = img.size
            img = img.resize((hw[1], hw[0]), Image.BILINEAR)
            k = np.asarray(m["intrinsics"][t], np.float64).copy()
            k[0] *= hw[1] / ow
            k[1] *= hw[0] / oh
            images.append(np.asarray(img, np.float32) / 255.0)
            c2ws.append(c2w)
            intrs.append(k)
            cam_ids.append(ci)
            frame_idx.append(t - start)

            if pix.load_sky_mask:
                sp = _sky_mask_path(img_path)
                if os.path.exists(sp):
                    sm = Image.open(sp).convert("L").resize(
                        (hw[1], hw[0]), Image.NEAREST
                    )
                    sky_masks.append(
                        (np.asarray(sm, np.float32) > 0).astype(np.float32)
                    )
            if pix.load_features:
                fp = _feature_path(img_path, pix.feature_model_type)
                if os.path.exists(fp):
                    features.append(np.load(fp).astype(np.float32))

    sky = (
        np.stack(sky_masks)
        if sky_masks and len(sky_masks) == len(images)
        else None
    )
    feats = None
    feat_pca = None
    if features and len(features) == len(images):
        feats = np.stack(features)
        if pix.target_feature_dim:
            feats, mat, fmin, fmax = reduce_features_pca(
                feats, pix.target_feature_dim
            )
            feat_pca = (mat, fmin, fmax)

    # ---- lidar: same FRACTION of its own (longer, faster) chain ----
    lidar = None
    if lidar_meta is not None and data_cfg.lidar_source.load_lidar:
        lcfg = data_cfg.lidar_source
        n_lidar_total = len(lidar_meta["timestamp"])
        l_end = int(n_lidar_total * scene_fraction)
        l_start = min(start, max(l_end - 1, 0))
        lo, ld, lr, lt = [], [], [], []
        for t in range(l_start, l_end):
            l2w = (
                world_ref
                @ np.asarray(lidar_meta["ego_pose"][t], np.float64)
                @ np.asarray(lidar_meta["extrinsics"][t], np.float64)
            )
            path = os.path.join(root, lidar_meta["filepath"][t])
            if not os.path.exists(path):
                continue
            # nuScenes .pcd.bin: float32 x, y, z, intensity, ring
            pts = np.fromfile(path, dtype=np.float32).reshape(-1, 5)[:, :3]
            mask = np.ones(len(pts), bool)
            if lcfg.truncated_max_range is not None:
                mask &= pts[:, 0] < lcfg.truncated_max_range
            if lcfg.truncated_min_range is not None:
                mask &= pts[:, 0] > lcfg.truncated_min_range
            pts = pts[mask]
            world_pts = pts @ l2w[:3, :3].T + l2w[:3, 3]
            origin = np.broadcast_to(l2w[:3, 3], world_pts.shape)
            dirs = world_pts - origin
            ranges = np.linalg.norm(dirs, axis=-1)
            lo.append(origin.astype(np.float32))
            ld.append(
                (dirs / np.maximum(ranges[:, None], 1e-8)).astype(np.float32)
            )
            lr.append(ranges.astype(np.float32))
            # map lidar scans onto the image frame axis by fraction so the
            # joint timestamp normalization lines up
            f_idx = int(
                (t - l_start) / max(l_end - l_start - 1, 1) * (end - start - 1)
            )
            lt.append(np.full(len(pts), f_idx, np.int64))
        if lo:
            lidar = dict(
                origins=np.concatenate(lo), viewdirs=np.concatenate(ld),
                ranges=np.concatenate(lr), frame_idx=np.concatenate(lt),
            )

    dataset = SceneDataset(
        images=np.stack(images).astype(np.float32),
        c2w=np.stack(c2ws),
        intrinsics=np.stack(intrs),
        frame_idx=np.asarray(frame_idx),
        cam_ids=np.asarray(cam_ids, np.int32),
        sky_masks=sky,
        dynamic_masks=None,  # not available for nuScenes
        features=feats,
        lidar=lidar,
        test_image_stride=0,  # reference defines no nuScenes test split
        buffer_downscale=pix.sampler.buffer_downscale,
        buffer_ratio=pix.sampler.buffer_ratio,
    )
    dataset.feat_pca = feat_pca
    dataset.scene_fraction = scene_fraction
    return dataset


def load_nuscenes_dataset(cfg: ConfigNode) -> SceneDataset:
    cam_meta, lidar_meta = create_or_load_metas(cfg)
    return load_nuscenes_from_meta(cam_meta, lidar_meta, cfg)
