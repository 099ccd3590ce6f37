"""Device-resident scene tensors and ray-batch sampling (port of
``emernerf_tpu/data/scene.py``).

The whole training scene lives on the device and batches are gathered
there: uniform pixel sampling, error-buffer importance sampling by Gumbel
top-k (``torch.multinomial`` without replacement in the original), and
uniform lidar sampling.  The random draws are inputs (:class:`PixelDraws`,
a lidar index tensor); ``draw_pixel`` and ``draw_lidar`` make them from a
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from emernerf_torch.data.rays import get_rays


@dataclasses.dataclass
class SceneTensors:
    """Everything the sampler needs, on one device.  Optional members are
    None when their supervision is off."""

    images: torch.Tensor  # (N, H, W, 3) float32 in [0, 1]
    c2w: torch.Tensor  # (N, 4, 4)
    intrinsics: torch.Tensor  # (N, 3, 3)
    normed_timestamps: torch.Tensor  # (N,)
    cam_ids: torch.Tensor  # (N,) int64
    train_indices: torch.Tensor  # (K,) int64 image indices available for training
    sky_masks: Optional[torch.Tensor] = None  # (N, H, W)
    features: Optional[torch.Tensor] = None  # (N, Hf, Wf, C)
    pixel_error_map: Optional[torch.Tensor] = None  # (N, H//bd, W//bd)
    lidar_origins: Optional[torch.Tensor] = None  # (M, 3)
    lidar_viewdirs: Optional[torch.Tensor] = None  # (M, 3)
    lidar_ranges: Optional[torch.Tensor] = None  # (M,)
    lidar_normed_timestamps: Optional[torch.Tensor] = None  # (M,)

    @property
    def image_hw(self):
        return self.images.shape[1], self.images.shape[2]


class PixelDraws(NamedTuple):
    """The draws of one pixel batch."""

    img: torch.Tensor  # (n_uniform,) positions in train_indices
    x: torch.Tensor  # (n_uniform,) in [0, W)
    y: torch.Tensor  # (n_uniform,) in [0, H)
    gumbel_u: Optional[torch.Tensor] = None  # (n_entries,) uniforms of the error buffer
    offsets: Optional[torch.Tensor] = None  # (2, n_roi) in [0, buffer_downscale)


def num_roi(scene: SceneTensors, num_rays: int, buffer_ratio: float) -> int:
    """Rays drawn from the error buffer: a ``buffer_ratio`` share, at most
    one per buffer entry (top-k without replacement)."""
    if scene.pixel_error_map is None:
        return 0
    n_entries = int(scene.train_indices.shape[0]) * int(
        scene.pixel_error_map.shape[1]) * int(scene.pixel_error_map.shape[2])
    return min(int(num_rays * buffer_ratio), n_entries)


def draw_pixel(scene: SceneTensors, num_rays: int, generator: torch.Generator,
               buffer_ratio: float = 0.0, buffer_downscale: int = 16) -> PixelDraws:
    dev = scene.images.device
    h, w = scene.image_hw
    n_roi = num_roi(scene, num_rays, buffer_ratio)
    n_uni = num_rays - n_roi

    def randint(high, shape):
        return torch.randint(0, high, shape, generator=generator, device=dev)

    draws = PixelDraws(randint(int(scene.train_indices.shape[0]), (n_uni,)),
                       randint(w, (n_uni,)), randint(h, (n_uni,)))
    if n_roi > 0:
        n_entries = int(scene.train_indices.shape[0]) * int(
            scene.pixel_error_map[0].numel())
        u = torch.rand((n_entries,), generator=generator, device=dev)
        draws = draws._replace(gumbel_u=u.clamp_min(1e-12),
                               offsets=randint(buffer_downscale, (2, n_roi)))
    return draws


def sample_pixel_batch(scene: SceneTensors, draws: PixelDraws, buffer_downscale: int = 16,
                       use_timestamps: bool = True):
    """A training pixel-ray batch; the error-buffer rays come after the
    uniform ones when ``draws`` carries them."""
    h, w = scene.image_hw
    img_idx = scene.train_indices[draws.img]
    x, y = draws.x, draws.y
    if draws.offsets is not None:
        err = scene.pixel_error_map[scene.train_indices]  # (K, hb, wb)
        _, hb, wb = err.shape
        logits = torch.log(err.reshape(-1).clamp_min(1e-12))
        gumbel = -torch.log(-torch.log(draws.gumbel_u))
        n_roi = draws.offsets.shape[1]
        # top-k as a stable descending sort: ties go to the lower index
        flat_idx = torch.sort(logits + gumbel, descending=True, stable=True)[1][:n_roi]
        y_b = (flat_idx % (hb * wb)) // wb
        x_b = flat_idx % wb
        img_r = scene.train_indices[flat_idx // (hb * wb)]
        y_r = (y_b * buffer_downscale + draws.offsets[0]).clamp(0, h - 1)
        x_r = (x_b * buffer_downscale + draws.offsets[1]).clamp(0, w - 1)
        img_idx = torch.cat([img_idx, img_r])
        x, y = torch.cat([x, x_r]), torch.cat([y, y_r])
    origins, viewdirs, dnorm = get_rays(x, y, scene.c2w[img_idx], scene.intrinsics[img_idx])
    batch = {
        "origins": origins,
        "viewdirs": viewdirs,
        "direction_norms": dnorm,
        "pixel_coords": torch.stack([y / h, x / w], dim=-1).float(),
        "pixels": scene.images[img_idx, y, x],
        "img_idx": img_idx,
        "cam_idx": scene.cam_ids[img_idx],
    }
    if use_timestamps:
        batch["normed_timestamps"] = scene.normed_timestamps[img_idx]
    if scene.sky_masks is not None:
        batch["sky_masks"] = scene.sky_masks[img_idx, y, x]
    if scene.features is not None:
        # the feature map's cell of each drawn pixel
        fh, fw = scene.features.shape[1:3]
        fy = (y * (fh / h)).long()
        fx = (x * (fw / w)).long()
        batch["features"] = scene.features[img_idx, fy, fx]
    return batch


def draw_lidar(scene: SceneTensors, num_rays: int, generator: torch.Generator) -> torch.Tensor:
    return torch.randint(0, int(scene.lidar_origins.shape[0]), (num_rays,),
                         generator=generator, device=scene.lidar_origins.device)


def sample_lidar_batch(scene: SceneTensors, idx: torch.Tensor):
    """A uniform lidar-ray batch at the drawn ray indices."""
    return {
        "origins": scene.lidar_origins[idx],
        "viewdirs": scene.lidar_viewdirs[idx],
        "ranges": scene.lidar_ranges[idx],
        "normed_timestamps": scene.lidar_normed_timestamps[idx],
    }


def update_pixel_error_map(scene: SceneTensors, pred_rgbs, gt_rgbs,
                           dynamic_opacities=None) -> SceneTensors:
    """Refresh the importance buffer from low-res renders: per-pixel |error|
    mean over channels, dynamic regions x5, then min-max normalized."""
    err = (gt_rgbs - pred_rgbs).abs().mean(dim=-1)
    if dynamic_opacities is not None:
        err = torch.where(dynamic_opacities > 0.1, err * 5.0, err)
    err = (err - err.min()) / (err.max() - err.min()).clamp_min(1e-8)
    return dataclasses.replace(scene, pixel_error_map=err)
