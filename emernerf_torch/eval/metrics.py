"""Quality metrics (PSNR / SSIM / depth RMSE / scene-flow / occupancy-kNN):
the port's own copy of ``emernerf_tpu/eval/metrics.py`` (the two must
agree, and ``tests/test_torch_imports.py`` holds them to it).

Counterparts of the original EmerNeRF's datasets/metrics.py.  SSIM is implemented
here directly (skimage is not a dependency): the standard Wang et al. form
with a 7x7 uniform filter, matching skimage.metrics.structural_similarity's
defaults (gaussian_weights=False, win_size=7, K1=0.01, K2=0.03,
channel_axis=-1, data_range=1.0).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def compute_psnr(pred, gt) -> float:
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    mse = np.mean((pred - gt) ** 2)
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def compute_valid_depth_rmse(pred, gt) -> float:
    """(metrics.py:12-28): RMSE over rays with a positive gt return."""
    pred = np.asarray(pred).reshape(-1)
    gt = np.asarray(gt).reshape(-1)
    mask = gt > 0
    if mask.sum() == 0:
        return 0.0
    return float(np.sqrt(np.mean((pred[mask] - gt[mask]) ** 2)))


def _uniform_filter_2d(img: np.ndarray, win: int) -> np.ndarray:
    """Mean filter via integral images; 'valid' region only."""
    pad = np.zeros((img.shape[0] + 1, img.shape[1] + 1), np.float64)
    np.cumsum(np.cumsum(img, axis=0), axis=1, out=pad[1:, 1:])
    s = (
        pad[win:, win:] - pad[:-win, win:] - pad[win:, :-win] + pad[:-win, :-win]
    )
    return s / (win * win)


def compute_ssim(pred, gt, data_range: float = 1.0, win_size: int = 7,
                 full: bool = False):
    """Mean SSIM between two (H, W, C) or (H, W) images in [0, 1].
    ``full=True`` also returns the per-pixel SSIM map (channel-averaged),
    used for dynamic-masked SSIM (reference video_utils.py:222-231)."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.ndim == 2:
        pred, gt = pred[..., None], gt[..., None]
    # images smaller than the window (tiny debug renders): shrink the
    # window to the largest odd size that fits, so the valid map is
    # non-empty (skimage raises here; we degrade gracefully)
    win_size = min(win_size, pred.shape[0], pred.shape[1])
    if win_size % 2 == 0:
        win_size -= 1
    win_size = max(win_size, 1)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    # skimage's filter normalization: unbiased covariance (N/(N-1))
    npts = win_size * win_size
    cov_norm = npts / (npts - 1) if npts > 1 else 1.0
    maps = []
    for c in range(pred.shape[-1]):
        x, y = pred[..., c], gt[..., c]
        ux = _uniform_filter_2d(x, win_size)
        uy = _uniform_filter_2d(y, win_size)
        uxx = _uniform_filter_2d(x * x, win_size)
        uyy = _uniform_filter_2d(y * y, win_size)
        uxy = _uniform_filter_2d(x * y, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
        b1, b2 = ux**2 + uy**2 + c1, vx + vy + c2
        maps.append((a1 * a2) / (b1 * b2))
    ssim_map = np.mean(np.stack(maps, axis=-1), axis=-1)
    if full:
        # the windowed stats only cover the 'valid' region; pad the map
        # back to image size (edge-replicate) so callers can mask it with
        # full-resolution masks (skimage full=True is also image-sized)
        p0 = (pred.shape[0] - ssim_map.shape[0]) // 2
        p1 = (pred.shape[1] - ssim_map.shape[1]) // 2
        ssim_full = np.pad(
            ssim_map,
            (
                (p0, pred.shape[0] - ssim_map.shape[0] - p0),
                (p1, pred.shape[1] - ssim_map.shape[1] - p1),
            ),
            mode="edge",
        )
        return float(ssim_map.mean()), ssim_full
    return float(ssim_map.mean())


def compute_scene_flow_metrics(pred: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """NSFP-style flow metrics (metrics.py:73-128): EPE3D, strict/relaxed
    accuracy, outlier rate, mean angle error."""
    pred = np.asarray(pred, np.float64)
    labels = np.asarray(labels, np.float64)
    l2_norm = np.linalg.norm(pred - labels, axis=-1)
    epe3d = float(l2_norm.mean())

    sf_norm = np.linalg.norm(labels, axis=-1)
    rel_err = l2_norm / (sf_norm + 1e-20)
    acc3d_strict = float(
        np.logical_or(l2_norm < 0.05, rel_err < 0.05).mean() * 100.0
    )
    acc3d_relax = float(
        np.logical_or(l2_norm < 0.1, rel_err < 0.1).mean() * 100.0
    )
    outlier = float(np.logical_or(l2_norm > 0.3, rel_err > 0.1).mean() * 100.0)

    # angle error against unit-augmented vectors
    unit_pred = np.concatenate([pred, np.ones_like(pred[..., :1])], -1)
    unit_lab = np.concatenate([labels, np.ones_like(labels[..., :1])], -1)
    unit_pred = unit_pred / np.linalg.norm(unit_pred, axis=-1, keepdims=True)
    unit_lab = unit_lab / np.linalg.norm(unit_lab, axis=-1, keepdims=True)
    dot = np.clip((unit_pred * unit_lab).sum(-1), -1.0, 1.0)
    angle = float(np.arccos(dot).mean())

    return {
        "EPE3D": epe3d,
        "acc3d_strict": acc3d_strict,
        "acc3d_relax": acc3d_relax,
        "angle_error": angle,
        "outlier": outlier,
    }


def knn_predict(
    queries: np.ndarray,  # (Q, D) normalized features
    memory_bank: np.ndarray,  # (M, D)
    memory_labels: np.ndarray,  # (M,)
    n_classes: int,
    knn_k: int = 1,
    knn_t: float = 0.1,
    similarity: str = "cosine",
) -> np.ndarray:
    """kNN soft-vote classifier for few-shot occupancy evaluation
    (metrics.py:180-246)."""
    if similarity == "cosine":
        qn = queries / np.linalg.norm(queries, axis=-1, keepdims=True)
        mn = memory_bank / np.linalg.norm(memory_bank, axis=-1, keepdims=True)
        sim = qn @ mn.T
    elif similarity == "l2":
        sim = -np.linalg.norm(
            queries[:, None, :] - memory_bank[None, :, :], axis=-1
        )
    else:
        raise ValueError(similarity)

    idx = np.argsort(-sim, axis=-1)[:, :knn_k]
    sim_k = np.take_along_axis(sim, idx, axis=-1)
    labels_k = memory_labels[idx]
    weights = np.exp(sim_k / knn_t)
    scores = np.zeros((len(queries), n_classes))
    for c in range(n_classes):
        scores[:, c] = (weights * (labels_k == c)).sum(-1)
    return scores.argmax(-1)
