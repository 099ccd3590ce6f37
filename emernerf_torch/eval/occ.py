"""Few-shot semantic-occupancy evaluation (port of ``emernerf_tpu/eval/occ.py``).

Voxel-center class annotations (Occ3D) of a few "annotated" frames are
lifted to per-class feature centroids by querying the field's DINO head
(``query_attributes``' ``dino_feat``), then the held-out frames are
classified by their nearest centroid; reports micro, macro and per-class
accuracy and the density cover rate.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

from emernerf_torch.data.utils import voxel_coords_to_world_coords
from emernerf_torch.eval.metrics import knn_predict
from emernerf_torch.eval.points import PointQueryEngine

# Occ3D-Waymo class ids 0..14
OCC3D_LABELS = {
    0: "general_obj", 1: "vehicle", 2: "pedestrian", 3: "sign",
    4: "cyclist", 5: "traffic_light", 6: "pole", 7: "construction_cone",
    8: "bicyle", 9: "motorcycle", 10: "building", 11: "vegetation",
    12: "tree_trunck", 13: "road", 14: "walkable",
}

# OccFn: frame index -> (world_coords (N,3), labels (N,), normed_times (N,))
OccFn = Callable[[int], Tuple[np.ndarray, np.ndarray, np.ndarray]]


def load_occ3d_frame(data_path: str, ego_to_world: np.ndarray, index: int,
                     num_frames: int, voxel_size: float = 0.1):
    """One Occ3D annotation frame of a preprocessed scene: the front half of
    the grid, camera-invisible voxels masked, occupied voxel centers in
    world space."""
    if voxel_size == 0.4:
        occ_path = os.path.join(data_path, "occ3d", f"{index:03d}_04.npz")
        res = [100, 200, 16]
        amin, amax = [0, -40, -1], [40, 40, 5.4]
    elif voxel_size == 0.1:
        occ_path = os.path.join(data_path, "occ3d", f"{index:03d}.npz")
        res = [800, 1600, 64]
        amin, amax = [0, -80, -5], [80, 80, 7.8]
    else:
        raise NotImplementedError(f"voxel size {voxel_size}")
    if not os.path.exists(occ_path):
        raise FileNotFoundError(occ_path)

    gt = np.load(occ_path)
    semantics = np.array(gt["voxel_label"])
    mask_camera = np.array(gt["final_voxel_state"])
    # front half only (no back cameras)
    semantics = semantics[len(semantics) // 2:]
    mask_camera = mask_camera[len(mask_camera) // 2:]
    semantics[semantics == 23] = 15  # free space
    semantics[mask_camera == 0] = 15  # camera-invisible

    occ = np.nonzero(semantics != 15)
    labels = semantics[occ].astype(np.int64)
    coords = np.stack(occ, -1).astype(np.float64)
    ego_coords = voxel_coords_to_world_coords(amin, amax, res, coords)
    world = ego_coords @ ego_to_world[:3, :3].T + ego_to_world[:3, 3]
    times = np.full(len(labels), index / max(num_frames - 1, 1), np.float32)
    return world.astype(np.float32), labels, times


def make_occ_fn(dataset) -> OccFn:
    """An OccFn over a Waymo dataset's Occ3D directory (the loader's
    per-frame ego->world poses)."""
    voxel_size = getattr(dataset, "occ_voxel_size", 0.1)

    def occ_fn(i: int):
        return load_occ3d_frame(dataset.data_path, dataset.ego_to_worlds[i], i,
                                dataset.num_frames, voxel_size=voxel_size)

    return occ_fn


def run_occ_eval(dataset, engine: PointQueryEngine, annotation_stride: int = 10,
                 density_threshold: float = 0.2) -> Dict:
    """The few-shot occupancy evaluation of a scene: every
    ``annotation_stride``-th frame annotates the centroids, the rest are
    classified."""
    occ_fn = make_occ_fn(dataset)
    train_indices = np.arange(0, dataset.num_frames, annotation_stride)
    annotated = set(train_indices.tolist())
    test_indices = [i for i in range(dataset.num_frames) if i not in annotated]
    centroids, centroid_labels = collect_centroids(train_indices, occ_fn, engine,
                                                   density_threshold=density_threshold)
    return eval_few_shot_occ(test_indices, occ_fn, engine, centroids, centroid_labels,
                             density_threshold=density_threshold)


def collect_centroids(train_indices: Sequence[int], occ_fn: OccFn, engine: PointQueryEngine,
                      n_classes: int = 15, feature_dim: int = 64,
                      density_threshold: float = 0.2):
    """Per-class mean features over the annotated frames."""
    feats_all, labels_all = [], []
    for i in train_indices:
        coords, labels, times = occ_fn(i)
        if len(coords) == 0:
            continue
        attrs = engine.query_attributes(coords, times)
        keep = attrs["density"] > density_threshold
        if keep.sum() == 0:
            continue
        feats_all.append(attrs["dino_feat"][keep])
        labels_all.append(labels[keep])
    if not feats_all:
        return np.zeros((n_classes, feature_dim), np.float32), np.arange(n_classes)
    feats = np.concatenate(feats_all)
    labels = np.concatenate(labels_all)
    centroids = np.zeros((n_classes, feats.shape[-1]), np.float32)
    for c in np.unique(labels):
        centroids[int(c)] = feats[labels == c].mean(0)
    return centroids, np.arange(n_classes)


def eval_few_shot_occ(test_indices: Sequence[int], occ_fn: OccFn, engine: PointQueryEngine,
                      centroids: np.ndarray, centroid_labels: np.ndarray,
                      label_mapping: Dict[int, str] = OCC3D_LABELS,
                      density_threshold: float = 0.2) -> Dict:
    """Nearest-centroid classification of the held-out frames."""
    n_classes = len(label_mapping)
    correct, total, measured, total_points = 0, 0, 0, 0
    correct_per_class = {c: 0 for c in label_mapping}
    total_per_class = {c: 0 for c in label_mapping}
    for i in test_indices:
        coords, labels, times = occ_fn(i)
        total_points += len(labels)
        if len(coords) == 0:
            continue
        attrs = engine.query_attributes(coords, times)
        keep = attrs["density"] > density_threshold
        if keep.sum() == 0:
            continue
        labels = labels[keep]
        measured += len(labels)
        pred = knn_predict(attrs["dino_feat"][keep], centroids, centroid_labels,
                           n_classes=n_classes, knn_k=1)
        hit = pred == labels
        correct += int(hit.sum())
        total += len(labels)
        for c in np.unique(labels):
            total_per_class[int(c)] += int((labels == c).sum())
            correct_per_class[int(c)] += int(hit[labels == c].sum())

    nonzero = [c for c in label_mapping if total_per_class[c] > 0]
    macro = (float(np.mean([correct_per_class[c] / total_per_class[c] for c in nonzero]))
             if nonzero else 0.0)
    return {
        "micro_accuracy": correct / max(total, 1),
        "macro_accuracy": macro,
        "per_class_accuracy": {name: correct_per_class[c] / (total_per_class[c] + 1e-10)
                               for c, name in label_mapping.items()},
        "cover_rate": measured / max(total_points, 1),
        "num_measured_points": measured,
        "num_total_points": total_points,
    }
