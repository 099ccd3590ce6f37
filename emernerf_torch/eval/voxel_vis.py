"""Voxel / scene-flow 3D visualization export (port of
``emernerf_tpu/eval/voxel_vis.py``).

Counterpart of the original EmerNeRF's utils/visualization_tools.py
(``visualize_voxels`` / ``visualize_scene_flow``): query the field over a
voxel grid (optionally per timestep), keep density-occupied cells, color
them with PCA-projected semantic features (by height without the feature
head, which the port does not build yet), and export.  Instead of a plotly
figure (plotly is not bundled here) the exporter writes a compressed
``.npz`` point set plus a self-contained HTML viewer (three.js from CDN)
that loads the embedded data — functionally the same inspection artifact.
"""

from __future__ import annotations

import base64
import json
import logging
import os
from typing import List, Optional

import numpy as np

from emernerf_torch.data.utils import voxel_coords_to_world_coords
from emernerf_torch.eval.points import PointQueryEngine
from emernerf_torch.utils.visualization import (
    apply_pca_colors,
    get_robust_pca,
    scene_flow_to_rgb,
)

logger = logging.getLogger("emernerf_torch")

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>EmerNeRF voxels</title>
<style>body{margin:0;background:#111}#info{position:absolute;color:#ccc;padding:8px;font-family:monospace}</style>
</head><body><div id="info">emernerf_torch voxel viewer — drag to orbit, wheel to zoom. frames: FRAME_COUNT</div>
<script type="module">
import * as THREE from 'https://unpkg.com/three@0.160.0/build/three.module.js';
import {OrbitControls} from 'https://unpkg.com/three@0.160.0/examples/jsm/controls/OrbitControls.js';
const data = JSON.parse(atob("B64DATA"));
const scene = new THREE.Scene();
const camera = new THREE.PerspectiveCamera(60, innerWidth/innerHeight, 0.1, 2000);
camera.position.set(-20, -20, 20); camera.up.set(0, 0, 1);
const renderer = new THREE.WebGLRenderer();
renderer.setSize(innerWidth, innerHeight); document.body.appendChild(renderer.domElement);
const controls = new OrbitControls(camera, renderer.domElement);
let frame = 0; const groups = [];
for (const f of data.frames) {
  const g = new THREE.Group();
  const geo = new THREE.BufferGeometry();
  geo.setAttribute('position', new THREE.Float32BufferAttribute(f.xyz, 3));
  geo.setAttribute('color', new THREE.Float32BufferAttribute(f.rgb, 3));
  g.add(new THREE.Points(geo, new THREE.PointsMaterial({size: data.voxel_size, vertexColors: true})));
  g.visible = false; scene.add(g); groups.push(g);
}
groups[0].visible = true;
setInterval(() => { groups[frame].visible=false; frame=(frame+1)%groups.length; groups[frame].visible=true; }, 500);
(function animate(){ requestAnimationFrame(animate); controls.update(); renderer.render(scene, camera); })();
</script></body></html>
"""


def voxel_grid(aabb: np.ndarray, voxel_size: float) -> np.ndarray:
    """World coordinates (X*Y*Z, 3) of the voxel cells over ``aabb``."""
    amin, amax = aabb[:3], aabb[3:]
    res = np.maximum(((amax - amin) / voxel_size).astype(int), 1)
    return voxel_coords_to_world_coords(amin, amax, res).reshape(-1, 3)


def extract_occupied_voxels(
    engine: PointQueryEngine,
    aabb: np.ndarray,
    voxel_size: float = 0.3,
    normed_time: Optional[float] = None,
    density_threshold: float = 0.5,
    max_points: int = 400_000,
):
    """Query the field on a voxel grid; returns (coords, feats-or-None)."""
    grid = voxel_grid(aabb, voxel_size)
    times = (
        np.full(len(grid), normed_time, np.float32)
        if normed_time is not None
        else None
    )
    attrs = engine.query_attributes(grid.astype(np.float32), times)
    occ = attrs["density"] > density_threshold
    coords = grid[occ]
    feats = attrs["dino_feat"][occ] if "dino_feat" in attrs else None
    if len(coords) > max_points:
        sel = np.random.default_rng(0).choice(
            len(coords), max_points, replace=False
        )
        coords = coords[sel]
        feats = feats[sel] if feats is not None else None
    return coords, feats


def visualize_voxels(
    engine: PointQueryEngine,
    aabb,
    save_path: str,
    timesteps: Optional[List[float]] = None,
    voxel_size: float = 0.3,
    density_threshold: float = 0.5,
    save_html: bool = True,
):
    """Export occupied voxels (+ PCA-colored features when available) as
    .npz and an optional standalone HTML viewer."""
    aabb = np.asarray(aabb, np.float32)
    timesteps = timesteps if timesteps is not None else [None]
    frames = []
    pca = None
    for t in timesteps:
        coords, feats = extract_occupied_voxels(
            engine, aabb, voxel_size, t, density_threshold
        )
        if feats is not None and len(feats):
            if pca is None:
                pca = get_robust_pca(feats.astype(np.float64))
            rgb = apply_pca_colors(feats, *pca)
        else:
            z = coords[:, 2:3] if len(coords) else np.zeros((0, 1))
            rng = z.max() - z.min() + 1e-6 if len(z) else 1.0
            zn = (z - (z.min() if len(z) else 0)) / rng
            rgb = np.concatenate([zn, 0.5 * np.ones_like(zn), 1.0 - zn], -1)
        frames.append({"xyz": coords.astype(np.float32), "rgb": rgb.astype(np.float32)})

    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    npz_path = save_path if save_path.endswith(".npz") else save_path + ".npz"
    np.savez_compressed(
        npz_path,
        **{
            f"frame{i}_{k}": f[k]
            for i, f in enumerate(frames)
            for k in ("xyz", "rgb")
        },
        voxel_size=voxel_size,
        aabb=aabb,
    )
    logger.info("Saved %d voxel frames to %s", len(frames), npz_path)

    if save_html:
        payload = {
            "voxel_size": float(voxel_size),
            "frames": [
                {"xyz": f["xyz"].reshape(-1).tolist(),
                 "rgb": f["rgb"].reshape(-1).tolist()}
                for f in frames
            ],
        }
        b64 = base64.b64encode(json.dumps(payload).encode()).decode()
        html = _HTML_TEMPLATE.replace("B64DATA", b64).replace(
            "FRAME_COUNT", str(len(frames))
        )
        html_path = npz_path.replace(".npz", ".html")
        with open(html_path, "w") as f:
            f.write(html)
        logger.info("Saved HTML voxel viewer to %s", html_path)
    return npz_path


def visualize_scene_flow(
    engine: PointQueryEngine,
    dataset,
    save_path: str,
    max_frames: int = 10,
):
    """Predicted-vs-GT lidar flow point clouds
    (visualization_tools.py:729-822), exported as npz."""
    frames = []
    for frame in range(min(dataset.num_frames, max_frames)):
        rays = dataset.get_lidar_render_rays(frame)
        if rays is None or len(rays["origins"]) == 0:
            continue
        points = (
            rays["origins"] + rays["viewdirs"] * rays["ranges"][:, None]
        )
        # drop lidar returns invisible from every camera — the field is
        # unsupervised there (reference visualization_tools.py:756-758)
        vis = dataset.get_valid_lidar_mask(frame, points)
        if vis.sum() == 0:
            continue
        points = points[vis]
        rays = {k: v[vis] for k, v in rays.items()}
        pred = engine.query_flow(
            points.astype(np.float32),
            rays["normed_timestamps"].astype(np.float32),
        )
        flow = np.where(
            pred["dynamic_density"][:, None] < 0.2, 0.0, pred["forward_flow"]
        )
        entry = {
            "xyz": points.astype(np.float32),
            "pred_flow": flow.astype(np.float32),
            "pred_rgb": scene_flow_to_rgb(flow),
        }
        lidar = dataset.lidar
        if lidar is not None and "flows" in lidar:
            mask = lidar["frame_idx"] == frame
            entry["gt_flow"] = lidar["flows"][mask].astype(np.float32)
        frames.append(entry)

    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    np.savez_compressed(
        save_path if save_path.endswith(".npz") else save_path + ".npz",
        **{f"frame{i}_{k}": f[k] for i, f in enumerate(frames) for k in f},
    )
    logger.info("Saved scene-flow visualization (%d frames)", len(frames))
    return save_path
