"""PSNR and SSIM of an eval frame on the card (``kernels/csrc/image_metrics.cu``).

The sums behind ``eval/metrics.py:compute_psnr`` and ``compute_ssim`` as
``eval/renderer.py:ImageRenderer.render_split`` reports them (:data:`SUMS`):
the squared errors of the unclipped values over the image, under a mask and
off it, the mask's pixel count, and the SSIM map of the values clipped to
[0, 1] summed over its valid region and, edge-padded to the image, under
the mask.  :func:`image_metric_sums` launches the kernel for CUDA tensors
(no fallback) and takes its plain float64 version
:func:`image_metric_sums_plain` for CPU tensors; it counts its launches.
:func:`frame_metrics` turns the fetched sums into the numbers.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from emernerf_torch import kernels

SUMS = ("se", "se_masked", "se_unmasked", "n_masked", "ssim", "ssim_masked")
TILE = (16, 32)  # valid positions a block, rows by columns (the kernel's kTileY, kTileX)
MAX_WIN = 7  # the kernel's kMaxWin: compute_ssim's window


def ssim_window(h: int, w: int, win: int = MAX_WIN) -> int:
    """The window ``compute_ssim`` takes on an h x w image: ``win``, or on
    images smaller than it the largest odd size that fits."""
    win = min(win, h, w)
    if win % 2 == 0:
        win -= 1
    return max(win, 1)


def n_blocks(h: int, w: int, win: int) -> int:
    """The kernel's blocks: one a tile of the (h - win + 1, w - win + 1)
    valid positions."""
    return -(-(h - win + 1) // TILE[0]) * -(-(w - win + 1) // TILE[1])


def _ssim_map(x: torch.Tensor, y: torch.Tensor, win: int) -> torch.Tensor:
    """``compute_ssim``'s channel-averaged map over the valid region, from
    direct window sums."""
    npts = win * win
    cov_norm = npts / (npts - 1) if npts > 1 else 1.0

    def mean(a):
        return a.unfold(0, win, 1).unfold(1, win, 1).sum((-2, -1)) / npts

    ux, uy, uxx, uyy, uxy = map(mean, (x, y, x * x, y * y, x * y))
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    a1, a2 = 2 * ux * uy + 0.01**2, 2 * vxy + 0.03**2
    b1, b2 = ux * ux + uy * uy + 0.01**2, vx + vy + 0.03**2
    return ((a1 * a2) / (b1 * b2)).mean(-1)


def image_metric_sums_plain(pred: torch.Tensor, gt: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            win: Optional[int] = None) -> torch.Tensor:
    """Plain version: the (6,) float64 :data:`SUMS`; ``win`` None leaves the
    SSIM sums 0."""
    p, g = pred.double(), gt.double()
    h, w, _ = p.shape
    m = (torch.zeros((h, w), dtype=torch.bool, device=p.device) if mask is None
         else mask.bool())
    se = ((p - g) ** 2).sum(-1)
    ssim = ssim_masked = p.new_zeros(())
    if win is not None:
        smap = _ssim_map(p.clamp(0, 1), g.clamp(0, 1), win)
        p0 = (win - 1) // 2
        rows = (torch.arange(h, device=p.device) - p0).clamp(0, smap.shape[0] - 1)
        cols = (torch.arange(w, device=p.device) - p0).clamp(0, smap.shape[1] - 1)
        ssim, ssim_masked = smap.sum(), smap[rows][:, cols][m].sum()
    return torch.stack([se.sum(), se[m].sum(), se[~m].sum(), m.sum().double(), ssim,
                        ssim_masked])


def _check(name, pred, gt, mask, win):
    if pred.dim() != 3 or pred.shape != gt.shape or pred.dtype != torch.float32 \
            or gt.dtype != torch.float32:
        raise ValueError(f"{name}: pred and gt must be (H, W, C) float32 of one shape")
    h, w, _ = pred.shape
    if pred.numel() == 0:
        raise ValueError(f"{name}: empty image")
    if mask is not None and (mask.shape != (h, w) or mask.dtype not in (torch.bool, torch.uint8)):
        raise ValueError(f"{name}: the mask must be (H, W) bool or uint8")
    if win is not None and (win % 2 == 0 or not 1 <= win <= min(MAX_WIN, h, w)):
        raise ValueError(f"{name}: the window must be odd, 1..{MAX_WIN}, at most H and W")


def image_metric_sums(pred: torch.Tensor, gt: torch.Tensor, mask: Optional[torch.Tensor] = None,
                      win: Optional[int] = None) -> torch.Tensor:
    """The (6,) float64 :data:`SUMS` of (H, W, C) float32 ``pred`` against
    ``gt``, ``mask`` (H, W) (None: no pixel under it) and the SSIM window
    ``win`` (None: no SSIM, the sums 0).  On the card two launches (the
    blocks' partials, then their sum in a fixed order: bit for bit between
    runs); the result stays on the device."""
    name = "image_metric_sums"
    _check(name, pred, gt, mask, win)
    if kernels.dispatch_device(name, pred) == "cpu":
        return image_metric_sums_plain(pred, gt, mask, win)
    kernels.require_cuda_inputs(name, pred, gt, *(() if mask is None else (mask,)))
    h, w, c = pred.shape
    k = 1 if win is None else win
    part = torch.empty((n_blocks(h, w, k), len(SUMS)), dtype=torch.float64, device=pred.device)
    out = torch.empty(len(SUMS), dtype=torch.float64, device=pred.device)
    err = kernels.load().emt_image_metrics(
        pred.data_ptr(), gt.data_ptr(), None if mask is None else mask.data_ptr(), h, w, c, k,
        int(win is not None), part.data_ptr(), out.data_ptr(), kernels.stream_ptr(pred.device))
    kernels.check(err, name)
    image_metric_sums.launches += 1
    return out


image_metric_sums.launches = 0


def psnr(mse: float) -> float:
    """``compute_psnr``'s decibels of a mean squared error."""
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def frame_metrics(sums: Sequence[float], shape: Tuple[int, int, int], win: Optional[int],
                  masked: bool) -> Dict[str, float]:
    """``render_split``'s numbers of one frame from its fetched :data:`SUMS`
    (``shape`` (H, W, C), ``win`` as summed): ``psnr`` and, with ``win``,
    ``ssim``; where ``masked``, ``masked_psnr`` (and ``masked_ssim``) if a
    pixel is under the mask and ``non_masked_psnr`` if one is off it."""
    se, se_masked, se_unmasked, n_masked, ssim, ssim_masked = sums
    h, w, c = shape
    out = {"psnr": psnr(se / (h * w * c))}
    if win is not None:
        out["ssim"] = ssim / ((h - win + 1) * (w - win + 1))
    if masked and n_masked > 0:
        out["masked_psnr"] = psnr(se_masked / (n_masked * c))
        if win is not None:
            out["masked_ssim"] = ssim_masked / n_masked
    if masked and h * w - n_masked > 0:
        out["non_masked_psnr"] = psnr(se_unmasked / ((h * w - n_masked) * c))
    return out
