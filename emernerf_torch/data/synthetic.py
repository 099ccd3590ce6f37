"""Analytic synthetic driving scene for tests, benchmarks, and CI (the
port's own copy of ``emernerf_tpu/data/synthetic.py``; the two must agree,
and ``tests/test_torch_imports.py`` holds them to it).

The original framework ships no runnable test data; this module
generates a self-consistent multi-view scene in the Waymo world convention
(x front, y left, z up; OpenCV cameras): a ground plane, a static sphere,
an optionally moving (dynamic) sphere, and a direction-dependent sky.
Images, sky masks, dynamic masks, and lidar returns are all ray-traced from
the same geometry, so a correct NeRF implementation can fit it quickly and
depth supervision is consistent with RGB.
"""

from __future__ import annotations

import numpy as np

# OpenCV camera axes expressed in the Waymo world frame: cam x (right) ->
# -y_world, cam y (down) -> -z_world, cam z (forward) -> +x_world.
OPENCV2WORLD = np.array(
    [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], dtype=np.float64
)

GROUND_A = np.array([0.32, 0.3, 0.3])
GROUND_B = np.array([0.45, 0.45, 0.42])
STATIC_SPHERE = dict(center=np.array([16.0, 3.0, 2.0]), radius=2.5,
                     color=np.array([0.8, 0.15, 0.1]))
DYNAMIC_SPHERE = dict(radius=1.8, color=np.array([0.1, 0.7, 0.2]))


def _dynamic_center(t: float) -> np.ndarray:
    """Dynamic sphere drives in -y across the road as t goes 0 -> 1."""
    return np.array([20.0, 4.0 - 8.0 * t, 1.5])


def _sky_color(dirs: np.ndarray) -> np.ndarray:
    """Simple direction-dependent sky: blue overhead fading to pale horizon."""
    up = np.clip(dirs[..., 2], 0.0, 1.0)[..., None]
    return (1 - up) * np.array([0.85, 0.88, 0.95]) + up * np.array([0.3, 0.5, 0.9])


def _intersect_plane(origins, dirs):
    """Ground plane z=0; returns t (inf when no hit)."""
    dz = dirs[..., 2]
    t = -origins[..., 2] / np.where(np.abs(dz) > 1e-8, dz, 1e-8)
    return np.where((dz < -1e-8) & (t > 0), t, np.inf)


def _intersect_sphere(origins, dirs, center, radius):
    oc = origins - center
    b = (oc * dirs).sum(-1)
    c = (oc * oc).sum(-1) - radius**2
    disc = b * b - c
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    return np.where((disc > 0) & (t > 0), t, np.inf)


def _trace(origins, dirs, t_norm: float, dynamic: bool):
    """Returns (rgb, depth(inf if sky), is_dynamic_hit)."""
    t_plane = _intersect_plane(origins, dirs)
    t_static = _intersect_sphere(
        origins, dirs, STATIC_SPHERE["center"], STATIC_SPHERE["radius"]
    )
    t_dyn = (
        _intersect_sphere(
            origins, dirs, _dynamic_center(t_norm), DYNAMIC_SPHERE["radius"]
        )
        if dynamic
        else np.full_like(t_plane, np.inf)
    )
    t_hit = np.minimum(np.minimum(t_plane, t_static), t_dyn)

    # checkerboard ground
    hit_pts = origins + dirs * np.where(np.isfinite(t_hit), t_hit, 0.0)[..., None]
    checker = ((np.floor(hit_pts[..., 0] / 4) + np.floor(hit_pts[..., 1] / 4)) % 2)
    ground_rgb = np.where(checker[..., None] > 0.5, GROUND_B, GROUND_A)

    rgb = _sky_color(dirs)
    rgb = np.where((t_plane == t_hit)[..., None] & np.isfinite(t_hit)[..., None],
                   ground_rgb, rgb)
    rgb = np.where((t_static == t_hit)[..., None] & np.isfinite(t_hit)[..., None],
                   STATIC_SPHERE["color"], rgb)
    rgb = np.where((t_dyn == t_hit)[..., None] & np.isfinite(t_hit)[..., None],
                   DYNAMIC_SPHERE["color"], rgb)
    # cheap lambert shading on spheres for texture
    shade = 0.7 + 0.3 * np.clip(-dirs[..., 2], 0, 1)
    rgb = rgb * shade[..., None]
    is_dynamic = (t_dyn == t_hit) & np.isfinite(t_hit)
    is_ground = (t_plane == t_hit) & np.isfinite(t_hit)
    return rgb.astype(np.float32), t_hit, is_dynamic, is_ground


def make_camera_poses(num_frames: int, num_cams: int = 1):
    """Ego moves +1.5 m/frame along x; cameras at z=2 with small yaw offsets
    per camera (front / front-left / front-right)."""
    yaws = [0.0, 0.6, -0.6, 1.2, -1.2][:num_cams]
    c2ws = []
    for i in range(num_frames):
        for yaw in yaws:
            rz = np.array(
                [
                    [np.cos(yaw), -np.sin(yaw), 0.0],
                    [np.sin(yaw), np.cos(yaw), 0.0],
                    [0.0, 0.0, 1.0],
                ]
            )
            c2w = np.eye(4)
            c2w[:3, :3] = rz @ OPENCV2WORLD
            c2w[:3, 3] = np.array([1.5 * i, 0.0, 2.0])
            c2ws.append(c2w)
    return np.stack(c2ws).astype(np.float32)


def make_synthetic_scene(
    num_frames: int = 8,
    num_cams: int = 1,
    hw=(40, 60),
    dynamic: bool = False,
    num_lidar_rays_per_frame: int = 512,
    seed: int = 0,
):
    """Build a dict of numpy arrays in the SceneTensors layout."""
    rng = np.random.default_rng(seed)
    h, w = hw
    focal = float(w)
    intrinsic = np.array(
        [[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], dtype=np.float32
    )

    c2ws = make_camera_poses(num_frames, num_cams)
    n = len(c2ws)
    frame_of = np.repeat(np.arange(num_frames), num_cams)
    t_norm = (
        frame_of / max(num_frames - 1, 1)
    ).astype(np.float32)
    cam_ids = np.tile(np.arange(num_cams), num_frames).astype(np.int32)

    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    images = np.zeros((n, h, w, 3), np.float32)
    sky_masks = np.zeros((n, h, w), np.float32)
    dynamic_masks = np.zeros((n, h, w), np.float32)

    for i in range(n):
        cam_dirs = np.stack(
            [
                (xs - intrinsic[0, 2] + 0.5) / intrinsic[0, 0],
                (ys - intrinsic[1, 2] + 0.5) / intrinsic[1, 1],
                np.ones_like(xs, dtype=np.float64),
            ],
            axis=-1,
        )
        dirs = cam_dirs @ c2ws[i, :3, :3].T
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        origins = np.broadcast_to(c2ws[i, :3, 3], dirs.shape)
        rgb, t_hit, is_dyn, _ = _trace(origins, dirs, float(t_norm[i]), dynamic)
        images[i] = np.clip(rgb, 0, 1)
        sky_masks[i] = (~np.isfinite(t_hit)).astype(np.float32)
        dynamic_masks[i] = is_dyn.astype(np.float32)

    # ---- lidar: random rays from the ego position of each frame ----
    lo, ld, lr, lt = [], [], [], []
    lflow, lclass, lground = [], [], []
    dt = 1.0 / max(num_frames - 1, 1)
    for f in range(num_frames):
        origin = np.array([1.5 * f, 0.0, 2.0])
        az = rng.uniform(-np.pi, np.pi, num_lidar_rays_per_frame)
        el = rng.uniform(np.deg2rad(-16.0), np.deg2rad(4.0),
                         num_lidar_rays_per_frame)
        dirs = np.stack(
            [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1
        )
        origins = np.broadcast_to(origin, dirs.shape)
        tn = f * dt
        _, t_hit, is_dyn, is_ground = _trace(origins, dirs, tn, dynamic)
        valid = np.isfinite(t_hit) & (t_hit < 75.0)
        lo.append(origins[valid])
        ld.append(dirs[valid])
        lr.append(t_hit[valid])
        lt.append(np.full(valid.sum(), tn))
        # analytic per-scan flow: points on the dynamic sphere translate
        # with it; everything else is static
        sphere_flow = _dynamic_center(tn + dt) - _dynamic_center(tn)
        flow = np.where(is_dyn[valid][:, None], sphere_flow, 0.0)
        lflow.append(flow)
        lclass.append(is_dyn[valid].astype(np.int64))
        lground.append(is_ground[valid])

    lidar_origins = np.concatenate(lo).astype(np.float32)
    lidar_viewdirs = np.concatenate(ld).astype(np.float32)
    lidar_ranges = np.concatenate(lr).astype(np.float32)
    lidar_times = np.concatenate(lt).astype(np.float32)
    lidar_flows = np.concatenate(lflow).astype(np.float32)
    lidar_classes = np.concatenate(lclass)
    lidar_ground = np.concatenate(lground)

    pts = lidar_origins + lidar_viewdirs * lidar_ranges[:, None]
    aabb_min = np.quantile(pts, 0.02, axis=0)
    aabb_max = np.quantile(pts, 0.98, axis=0)
    aabb_max[2] = max(aabb_max[2], 20.0)
    aabb = np.concatenate([aabb_min, aabb_max]).astype(np.float32)

    return {
        "images": images,
        "sky_masks": sky_masks,
        "dynamic_masks": dynamic_masks,
        "c2w": c2ws,
        "intrinsics": np.tile(intrinsic[None], (n, 1, 1)),
        "normed_timestamps": t_norm,
        "cam_ids": cam_ids,
        "lidar_origins": lidar_origins,
        "lidar_viewdirs": lidar_viewdirs,
        "lidar_ranges": lidar_ranges,
        "lidar_normed_timestamps": lidar_times,
        "lidar_flows": lidar_flows,
        "lidar_flow_classes": lidar_classes,
        "lidar_ground": lidar_ground,
        "aabb": aabb,
        "num_frames": num_frames,
        "num_cams": num_cams,
        "time_diff": 1.0 / max(num_frames, 1),
    }
