"""EmerNeRF training losses (port of ``emernerf_tpu/losses/losses.py``).

Pure functions returning 0-d tensors.  Masked means are sum(loss * mask) /
sum(mask), as in the reference.  Every clip of a differentiable value is
:func:`emernerf_torch.ops.clip.clip`, which passes JAX's half gradient at a
bound.  Scalars that the reference computes as float32 on the device
(the line-of-sight epsilon and decay) come in as host floats.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from emernerf_torch.ops.clip import clip


def _elementwise(pred, gt, loss_type: str):
    diff = pred - gt
    if loss_type == "l2":
        return diff ** 2
    if loss_type == "l1":
        return diff.abs()
    if loss_type == "smooth_l1":  # torch default beta=1.0
        ad = diff.abs()
        return torch.where(ad < 1.0, 0.5 * diff ** 2, ad - 0.5)
    raise NotImplementedError(loss_type)


def real_value_loss(pred, gt, loss_type: str = "l2", coef: float = 1.0, mask=None):
    """RGB / feature loss."""
    loss = _elementwise(pred, gt, loss_type)
    if mask is not None:
        loss = loss * mask
    return loss.mean() * coef


def sky_loss_weights(weights, sky_mask, coef: float = 0.01):
    """Penalize sample weights on sky rays."""
    return (weights.square().sum(-1) * sky_mask).mean() * coef


def sky_loss_opacity(opacity, sky_mask, coef: float = 0.001, eps: float = 1e-6):
    """BCE(opacity, 1 - sky_mask)."""
    o = clip(opacity.squeeze(-1), eps, 1.0 - eps)
    target = 1.0 - sky_mask.to(o.dtype)
    bce = -(target * torch.log(o) + (1.0 - target) * torch.log(1.0 - o))
    return bce.mean() * coef


def normalize_depth(depth, max_depth: float = 80.0):
    return clip(depth / max_depth, 0.0, 1.0)


def depth_loss(pred_depth, gt_depth, loss_type: str = "l2", coef: float = 1.0,
               max_depth: float = 80.0):
    """Normalized depth loss, averaged over the valid returns
    (0.01 < gt < max_depth)."""
    pred = pred_depth.reshape(-1)
    gt = gt_depth.reshape(-1)
    valid = ((gt > 0.01) & (gt < max_depth)).to(pred.dtype)
    err = _elementwise(normalize_depth(pred, max_depth),
                       normalize_depth(gt, max_depth), loss_type)
    return (err * valid).sum() / valid.sum().clamp_min(1.0) * coef


def dirac_delta_approx(x, mu: float = 0.0, sigma: float = 1e-5):
    """Gaussian of width sigma; the scalars are formed in float32 as the
    reference forms them from its float32 sigma."""
    s = np.float32(sigma)
    norm = np.float32(1.0) / np.sqrt(np.float32(2.0 * math.pi) * s ** 2)
    return float(norm) * torch.exp(-((x - mu) ** 2) / float(np.float32(2.0) * s ** 2))


def line_of_sight_loss(gt_depth, weights, t_vals, epsilon: float, coef: float = 0.1,
                       coef_decay: float = 1.0):
    """Line-of-sight loss: weights to zero in the free space before the lidar
    return and toward a narrow Gaussian around it.  Empty and near terms are
    global means scaled by the fraction of rays with a return, as in the
    reference."""
    gt = gt_depth.reshape(-1)[:, None]
    t_vals = t_vals.detach()
    depth_mask = (gt[:, 0] > 0.0).to(weights.dtype)
    empty_mask = (t_vals < gt - epsilon).to(weights.dtype)
    near_mask = ((t_vals > gt - epsilon) & (t_vals < gt + epsilon)).to(weights.dtype)
    empty_loss = (weights.square() * empty_mask).sum(-1).mean()
    sigma = float(np.float32(epsilon) / np.float32(3.0))
    near_loss = ((weights - dirac_delta_approx(t_vals - gt, sigma=sigma)).square()
                 * near_mask).sum(-1).mean()
    sight = (empty_loss + near_loss) * depth_mask
    return sight.mean() * coef * coef_decay


def dynamic_regularization_loss(dynamic_density, static_density=None,
                                mask: Optional[torch.Tensor] = None,
                                loss_type: str = "sparsity", coef: float = 0.01,
                                entropy_skewness: float = 2.0):
    """Dynamic-density (or shadow) regularization."""
    if loss_type == "sparsity":
        loss = dynamic_density
        if mask is not None:
            loss = loss + 2.0 * dynamic_density * mask[..., None]
    elif loss_type == "entropy":
        ratio = dynamic_density / (dynamic_density + static_density + 1e-7)
        skewed = clip(ratio ** entropy_skewness, 1e-6, 1.0 - 1e-6)
        loss = -(skewed * torch.log(skewed)) - (1.0 - skewed) * torch.log(1.0 - skewed)
    else:
        raise NotImplementedError(loss_type)
    return loss.mean() * coef


def cycle_consistency_loss(forward_flow, forward_pred_backward_flow, backward_flow,
                           backward_pred_forward_flow, coef: float = 0.01,
                           mask: Optional[torch.Tensor] = None):
    """Warped-point flow should invert the original flow; ``mask`` (from the
    top-K temporal aggregation) restricts the mean to the samples whose
    cycle predictions were computed."""
    per = 0.5 * ((forward_flow.detach() + forward_pred_backward_flow) ** 2
                 + (backward_flow.detach() + backward_pred_forward_flow) ** 2)
    if mask is not None:
        m = mask[..., None]
        loss = (per * m).sum() / (m.sum() * per.shape[-1]).clamp_min(1.0)
    else:
        loss = per.mean()
    return loss * coef
