"""Dataset utilities: voxel<->world transforms, pose interpolation, ground
removal (numpy only): the port's own copy of ``emernerf_tpu/data/utils.py``
(``tests/test_torch_imports.py`` holds the two to the same results).
Counterpart of the original EmerNeRF's datasets/utils.py."""

from __future__ import annotations

import numpy as np


def voxel_coords_to_world_coords(aabb_min, aabb_max, voxel_resolution,
                                 points=None) -> np.ndarray:
    """Voxel-grid coordinates -> world (datasets/utils.py:9-55).  With
    ``points=None`` returns the dense (X, Y, Z, 3) grid of cell centers."""
    aabb_min = np.asarray(aabb_min, np.float64)
    aabb_max = np.asarray(aabb_max, np.float64)
    res = np.asarray(voxel_resolution, np.int64)
    if points is None:
        xs = [np.linspace(aabb_min[i], aabb_max[i], res[i]) for i in range(3)]
        grid = np.meshgrid(*xs, indexing="ij")
        return np.stack(grid, axis=-1)
    points = np.asarray(points, np.float64)
    voxel_size = (aabb_max - aabb_min) / res
    return aabb_min + points * voxel_size


def world_coords_to_voxel_coords(point, aabb_min, aabb_max,
                                 voxel_resolution) -> np.ndarray:
    """World -> integer voxel coordinates (datasets/utils.py:58-93)."""
    point = np.asarray(point, np.float64)
    aabb_min = np.asarray(aabb_min, np.float64)
    aabb_max = np.asarray(aabb_max, np.float64)
    res = np.asarray(voxel_resolution, np.int64)
    voxel_size = (aabb_max - aabb_min) / res
    return ((point - aabb_min) / voxel_size).astype(np.int64)


def _mat_to_quat(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z), Shepperd's method."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s]
        )
    i = np.argmax(np.diag(r))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(r[i, i] - r[j, j] - r[k, k] + 1.0) * 2
    q = np.empty(4)
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _slerp(q1: np.ndarray, q2: np.ndarray, alpha: float) -> np.ndarray:
    dot = np.dot(q1, q2)
    if dot < 0:
        q2, dot = -q2, -dot
    if dot > 0.9995:
        q = q1 + alpha * (q2 - q1)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(dot, -1, 1))
    return (
        np.sin((1 - alpha) * theta) * q1 + np.sin(alpha * theta) * q2
    ) / np.sin(theta)


def interpolate_matrices(t1: np.ndarray, t2: np.ndarray, alpha: float) -> np.ndarray:
    """SE(3) interpolation: slerp rotation + lerp translation
    (datasets/utils.py:96-123; note the reference weights t1 by alpha)."""
    out = np.eye(4)
    out[:3, 3] = alpha * t1[:3, 3] + (1 - alpha) * t2[:3, 3]
    q = _slerp(_mat_to_quat(t1[:3, :3]), _mat_to_quat(t2[:3, :3]), 1 - alpha)
    out[:3, :3] = _quat_to_mat(q)
    return out


def get_ground_label(pts: np.ndarray, n_iters: int = 10,
                     inlier_thresh: float = 0.15) -> np.ndarray:
    """Ground labeling by iterative SVD plane fitting on low points
    (behavioral equivalent of datasets/utils.py:126-216).  Returns a bool
    mask of ground points."""
    pts = np.asarray(pts, np.float64)
    # seed: points in the lowest height band
    z = pts[:, 2]
    seed = z < np.quantile(z, 0.3)
    candidates = pts[seed]
    if len(candidates) < 16:
        return np.zeros(len(pts), bool)

    inliers = candidates
    normal, d = np.array([0.0, 0.0, 1.0]), 0.0
    for _ in range(n_iters):
        centroid = inliers.mean(0)
        _, _, vt = np.linalg.svd(inliers - centroid, full_matrices=False)
        normal = vt[-1]
        if normal[2] < 0:
            normal = -normal
        d = -centroid @ normal
        dist = np.abs(candidates @ normal + d)
        new_inliers = candidates[dist < inlier_thresh]
        if len(new_inliers) < 3:
            break
        inliers = new_inliers
    return np.abs(pts @ normal + d) < inlier_thresh
