"""The driving scene both sides read, made by the benchmark on the device at
the configuration's scale: its cameras, frames and image size, and a
spinning lidar's scan pattern.

The geometry is the analytic one of the port's synthetic scene (a
checkerboard ground plane, static spheres, a dynamic sphere crossing the
road, a direction-dependent sky; Waymo's world frame, OpenCV cameras),
stretched along the ego's path: a static sphere every ``SPHERE_GAP_M`` of
road and the dynamic sphere crossing ahead of the ego every
``CROSSING_FRAMES`` frames, so that every frame sees both.  Images, sky and
dynamic masks and lidar returns are ray-traced from it in chunks of images
on the device, then kept on the host as a loader keeps a scene it read.

The scene does not depend on ``--seed``: every seed trains on the same
sizes and the same rows, and only the weights and the draws change.

Configuration keys: the port's ``data.pixel_source.num_cams``,
``data.synthetic.{num_frames,image_height,image_width}`` and
``data.lidar_source.{truncated_min_range,truncated_max_range}`` (after the
cell's overrides), and the configuration's own ``scene``:
``lidar_beams``, ``lidar_azimuths``, ``lidar_elevation_deg`` ([low, high])
and ``ego_step_m``.
"""

from __future__ import annotations

import math
import types
from typing import Any, Dict

import numpy as np
import torch

# OpenCV camera axes in the world frame (x front, y left, z up)
OPENCV2WORLD = torch.tensor([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]],
                            dtype=torch.float64)
CAM_YAWS = (0.0, 0.6, -0.6, 1.2, -1.2)  # front, front-left, front-right, sides
CAM_HEIGHT_M = 2.0
SPHERE_GAP_M = 40.0
STATIC_RADIUS, DYNAMIC_RADIUS = 2.5, 1.8
CROSSING_FRAMES = 8
STATIC_RGB, DYNAMIC_RGB = (0.8, 0.15, 0.1), (0.1, 0.7, 0.2)
GROUND_A, GROUND_B = (0.32, 0.3, 0.3), (0.45, 0.45, 0.42)
IMAGES_PER_CHUNK = 8
LIDAR_FRAMES_PER_CHUNK = 25


def dotted(config: Dict[str, Any], overrides: Dict[str, Any], key: str):
    """``key`` of the configuration's ``cfg`` with the cell's overrides."""
    if key in overrides:
        return overrides[key]
    node = config["cfg"]
    for part in key.split("."):
        node = node[part]
    return node


def _dynamic_center(ego_x, f):
    """The dynamic sphere at (fractional) frame f: 20 m ahead of the ego,
    crossing the road in -y once every CROSSING_FRAMES frames."""
    phase = torch.remainder(f / CROSSING_FRAMES, 1.0)
    return torch.stack([ego_x + 20.0, 4.0 - 8.0 * phase, torch.full_like(phase, 1.5)], -1)


def _hit_sphere(o, d, c, r):
    oc = o - c
    b = (oc * d).sum(-1)
    disc = b * b - ((oc * oc).sum(-1) - r * r)
    t = -b - torch.sqrt(disc.clamp_min(0.0))
    return torch.where((disc > 0) & (t > 0), t, torch.full_like(t, math.inf))


def _trace(o, d, ego_x, f, statics):
    """(rgb, t of the hit (inf: sky), dynamic hit) of rays o + t d; o, d
    (..., 3), ego_x and f broadcast against the rays' leading shape."""
    dz = d[..., 2]
    t_plane = -o[..., 2] / torch.where(dz.abs() > 1e-8, dz, torch.full_like(dz, 1e-8))
    t_plane = torch.where((dz < -1e-8) & (t_plane > 0), t_plane, torch.full_like(dz, math.inf))
    t_static = torch.full_like(dz, math.inf)
    for c in statics:
        t_static = torch.minimum(t_static, _hit_sphere(o, d, c, STATIC_RADIUS))
    t_dyn = _hit_sphere(o, d, _dynamic_center(ego_x, f), DYNAMIC_RADIUS)
    t_hit = torch.minimum(torch.minimum(t_plane, t_static), t_dyn)
    hit = torch.isfinite(t_hit)
    p = o + d * torch.where(hit, t_hit, torch.zeros_like(t_hit))[..., None]
    checker = torch.remainder(torch.floor(p[..., 0] / 4) + torch.floor(p[..., 1] / 4), 2) > 0.5
    tone = lambda v: torch.tensor(v, dtype=o.dtype, device=o.device)  # noqa: E731
    up = d[..., 2].clamp(0.0, 1.0)[..., None]
    rgb = (1 - up) * tone((0.85, 0.88, 0.95)) + up * tone((0.3, 0.5, 0.9))
    rgb = torch.where(((t_plane == t_hit) & hit)[..., None],
                      torch.where(checker[..., None], tone(GROUND_B), tone(GROUND_A)), rgb)
    rgb = torch.where(((t_static == t_hit) & hit)[..., None], tone(STATIC_RGB), rgb)
    is_dyn = (t_dyn == t_hit) & hit
    rgb = torch.where(is_dyn[..., None], tone(DYNAMIC_RGB), rgb)
    rgb = rgb * (0.7 + 0.3 * (-d[..., 2]).clamp(0.0, 1.0))[..., None]
    return rgb.clamp(0.0, 1.0), t_hit, is_dyn


def make_scene(config: Dict[str, Any], overrides: Dict[str, Any], device) -> Dict[str, Any]:
    """The scene as numpy arrays on the host (the SceneDataset layout), made
    on ``device``."""
    spec = config["scene"]
    frames = int(dotted(config, overrides, "data.synthetic.num_frames"))
    cams = int(dotted(config, overrides, "data.pixel_source.num_cams"))
    h = int(dotted(config, overrides, "data.synthetic.image_height"))
    w = int(dotted(config, overrides, "data.synthetic.image_width"))
    r_min = float(dotted(config, overrides, "data.lidar_source.truncated_min_range"))
    r_max = float(dotted(config, overrides, "data.lidar_source.truncated_max_range"))
    step = float(spec["ego_step_m"])
    dev = torch.device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    path = step * max(frames - 1, 0)
    statics = [torch.tensor([16.0 + SPHERE_GAP_M * k, 3.0 if k % 2 == 0 else -3.0, 2.0], **f32)
               for k in range(int(path // SPHERE_GAP_M) + 3)]

    # cameras: the ego at (step * frame, 0, CAM_HEIGHT_M), yawed per camera
    n = frames * cams
    yaws = torch.tensor(CAM_YAWS[:cams], dtype=torch.float64)
    rz = torch.zeros(cams, 3, 3, dtype=torch.float64)
    rz[:, 0, 0], rz[:, 0, 1] = torch.cos(yaws), -torch.sin(yaws)
    rz[:, 1, 0], rz[:, 1, 1], rz[:, 2, 2] = torch.sin(yaws), torch.cos(yaws), 1.0
    c2w = torch.eye(4, dtype=torch.float64).repeat(n, 1, 1)
    c2w[:, :3, :3] = (rz @ OPENCV2WORLD).repeat(frames, 1, 1)
    frame_idx = np.repeat(np.arange(frames), cams)
    c2w[:, 0, 3] = torch.as_tensor(step * frame_idx, dtype=torch.float64)
    c2w[:, 2, 3] = CAM_HEIGHT_M
    c2w = c2w.float().numpy()
    focal = float(w)
    intr = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)

    images = np.empty((n, h, w, 3), np.float32)
    sky = np.empty((n, h, w), np.float32)
    dyn = np.empty((n, h, w), np.float32)
    # host views the device results are copied into, one copy each
    images_t, sky_t, dyn_t = map(torch.from_numpy, (images, sky, dyn))
    ys, xs = torch.meshgrid(torch.arange(h, **f32), torch.arange(w, **f32), indexing="ij")
    cam_dirs = torch.stack([(xs - w / 2 + 0.5) / focal, (ys - h / 2 + 0.5) / focal,
                            torch.ones_like(xs)], -1)  # (h, w, 3)
    c2w_dev = torch.as_tensor(c2w, device=dev)
    for i0 in range(0, n, IMAGES_PER_CHUNK):
        i1 = min(i0 + IMAGES_PER_CHUNK, n)
        rot = c2w_dev[i0:i1, :3, :3]
        d = torch.einsum("hwk,njk->nhwj", cam_dirs, rot)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        o = c2w_dev[i0:i1, None, None, :3, 3].expand_as(d)
        f = torch.as_tensor(frame_idx[i0:i1], **f32)[:, None, None]
        rgb, t_hit, is_dyn = _trace(o, d, c2w_dev[i0:i1, 0, 3][:, None, None], f, statics)
        images_t[i0:i1].copy_(rgb)
        sky_t[i0:i1].copy_(~torch.isfinite(t_hit))
        dyn_t[i0:i1].copy_(is_dyn)

    # lidar: a fixed scan pattern (beams x azimuths) from the ego of each
    # frame; the returns inside the configuration's range window are kept
    el = torch.deg2rad(torch.linspace(*map(float, spec["lidar_elevation_deg"]),
                                      int(spec["lidar_beams"]), **f32))
    az = torch.arange(int(spec["lidar_azimuths"]), **f32) * (2 * math.pi /
                                                              int(spec["lidar_azimuths"]))
    el, az = torch.meshgrid(el, az, indexing="ij")
    ld_one = torch.stack([torch.cos(el) * torch.cos(az), torch.cos(el) * torch.sin(az),
                          torch.sin(el)], -1).reshape(-1, 3)
    lo, ld, lr, lf = [], [], [], []
    for f0 in range(0, frames, LIDAR_FRAMES_PER_CHUNK):
        f = torch.arange(f0, min(f0 + LIDAR_FRAMES_PER_CHUNK, frames), **f32)[:, None]
        o = torch.stack([step * f, torch.zeros_like(f), torch.full_like(f, CAM_HEIGHT_M)],
                        -1).expand(-1, ld_one.shape[0], 3)
        d = ld_one.expand_as(o)
        _, t_hit, _ = _trace(o, d, step * f, f, statics)
        keep = torch.isfinite(t_hit) & (t_hit < r_max) & (t_hit > r_min)
        lo.append(o[keep].cpu())
        ld.append(d[keep].cpu())
        lr.append(t_hit[keep].cpu())
        lf.append(f.long().expand_as(keep)[keep].cpu())
    lidar = dict(origins=torch.cat(lo).numpy(), viewdirs=torch.cat(ld).numpy(),
                 ranges=torch.cat(lr).numpy(), frame_idx=torch.cat(lf).numpy())

    pts = lidar["origins"] + lidar["viewdirs"] * lidar["ranges"][:, None]
    sub = pts[:: max(len(pts) // 100000, 1)]
    amin, amax = np.quantile(sub, 0.02, axis=0), np.quantile(sub, 0.98, axis=0)
    amax[2] = max(amax[2], 20.0)
    return dict(images=images, sky_masks=sky, dynamic_masks=dyn, c2w=c2w,
                intrinsics=np.tile(intr[None], (n, 1, 1)), frame_idx=frame_idx,
                cam_ids=np.tile(np.arange(cams), frames).astype(np.int32), lidar=lidar,
                aabb=np.concatenate([amin, amax]).astype(np.float32),
                test_image_stride=int(dotted(config, overrides,
                                             "data.pixel_source.test_image_stride")))


def facts(scene: Dict[str, Any]) -> types.SimpleNamespace:
    """What the reference builds its model, rays and checks from, worked
    out from the scene alone: the split, the timestamps normalised over the
    image and lidar frames together, and the scene's tables as CPU tensors."""
    fi = scene["frame_idx"]
    frames = int(fi.max()) + 1
    all_f = np.concatenate([fi, scene["lidar"]["frame_idx"]]).astype(np.float64)
    fmin, denom = all_f.min(), max(all_f.max() - all_f.min(), 1.0)
    ts = ((fi - fmin) / denom).astype(np.float32)
    lidar_ts = ((scene["lidar"]["frame_idx"] - fmin) / denom).astype(np.float32)
    stride = scene["test_image_stride"]
    test = np.arange(frames)[::stride] if stride > 0 else np.zeros(0, np.int64)
    is_test = np.isin(fi, test)
    train = np.nonzero(~is_test)[0]
    keep = ~np.isin(scene["lidar"]["frame_idx"], test)
    t = torch.from_numpy
    return types.SimpleNamespace(
        aabb=scene["aabb"], has_test_split=bool(is_test.any()), features=None,
        num_cams=int(scene["cam_ids"].max()) + 1, num_img_timesteps=frames,
        time_diff=1.0 / max(frames, 1),
        unique_normalized_training_timestamps=np.unique(ts[train]),
        lidar={}, sky_masks=np.zeros(0), c2w=scene["c2w"], intrinsics=scene["intrinsics"],
        normed_timestamps=ts, cam_ids=scene["cam_ids"],
        image_hw=tuple(scene["images"].shape[1:3]),
        tables=types.SimpleNamespace(
            images=t(scene["images"]), sky_masks=t(scene["sky_masks"]),
            c2w=t(scene["c2w"]), intrinsics=t(scene["intrinsics"]),
            normed_timestamps=t(ts), train_indices=t(train),
            lidar_origins=t(scene["lidar"]["origins"][keep]),
            lidar_viewdirs=t(scene["lidar"]["viewdirs"][keep]),
            lidar_ranges=t(scene["lidar"]["ranges"][keep]),
            lidar_normed_timestamps=t(lidar_ts[keep])))
