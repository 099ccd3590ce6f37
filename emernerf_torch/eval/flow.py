"""Lidar scene-flow evaluation (NSFP protocol), port of
``emernerf_tpu/eval/flow.py``.

Counterpart of the flow-eval block of the original EmerNeRF's
train_emernerf.py: per lidar frame, query the
emergent flow field at the lidar returns, zero flows on points the dynamic
field considers static (density < 0.2), and accumulate EPE3D /
acc3d-strict / acc3d-relax / angle / outlier metrics against the dataset's
flow annotations.  Ground points are optionally removed, following scene
-flow-estimation conventions.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from emernerf_torch.eval.metrics import compute_scene_flow_metrics
from emernerf_torch.eval.points import PointQueryEngine


def flow_eval_points(dataset, frame: int, remove_ground: bool = True):
    """The lidar returns of ``frame`` that the NSFP protocol scores: those
    with a flow class, without the ground when asked.  Returns (points
    (N, 3), normalized timestamps (N,), ground-truth flows (N, 3)), or None
    where no point is left."""
    lidar = dataset.lidar
    mask = lidar["frame_idx"] == frame
    if "flow_classes" in lidar:
        mask = mask & (lidar["flow_classes"] != -1)
    if remove_ground and "ground" in lidar:
        mask = mask & (~lidar["ground"])
    if mask.sum() == 0:
        return None
    points = lidar["origins"][mask] + lidar["viewdirs"][mask] * lidar["ranges"][mask][:, None]
    return points, dataset.lidar_normed_timestamps[mask], lidar["flows"][mask]


def evaluate_lidar_flow(
    engine: PointQueryEngine,
    dataset,
    remove_ground: bool = True,
    density_threshold: float = 0.2,
) -> Dict[str, float]:
    if dataset.lidar is None or "flows" not in dataset.lidar:
        raise ValueError("flow evaluation needs lidar flow annotations")
    all_metrics: Dict[str, list] = {
        "EPE3D": [], "acc3d_strict": [], "acc3d_relax": [],
        "angle_error": [], "outlier": [],
    }
    for frame in range(dataset.num_frames):
        scored = flow_eval_points(dataset, frame, remove_ground)
        if scored is None:
            continue
        points, times, gt_flows = scored
        pred = engine.query_flow(points.astype(np.float32), times.astype(np.float32))
        pred_flow = pred["forward_flow"]
        pred_flow = np.where(
            pred["dynamic_density"][:, None] < density_threshold, 0.0, pred_flow
        )
        m = compute_scene_flow_metrics(pred_flow, gt_flows)
        for k, v in m.items():
            all_metrics[k].append(v)
    return {k: float(np.mean(v)) if v else 0.0 for k, v in all_metrics.items()}
