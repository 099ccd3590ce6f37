"""Whole-image evaluation rendering (port of ``emernerf_tpu/eval/renderer.py``).

Renders a dataset split image by image through fixed-size ray chunks (the
last chunk is padded by repeating its final ray), optionally shading only
the top-K samples per ray, collects the per-ray maps and computes PSNR/SSIM
(+ dynamic- and static-masked variants) and, with the feature head, the
PSNR of the lifted features against the feature maps (``feat_psnr``,
``masked_feat_psnr``) with the numpy metrics of
``emernerf_torch/eval/metrics.py``.  With a process group each rank
renders its slice of every chunk and the chunk's outputs are gathered on
every rank (``parallel/mesh.py:shard_render_chunk``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from emernerf_torch import resolve_device
from emernerf_torch.eval import metrics
from emernerf_torch.parallel import mesh
from emernerf_torch.render.renderer import render_ray_batch
from emernerf_torch.utils.trace import span

# per-ray outputs worth reshaping into image maps
_MAP_KEYS = (
    "rgb", "depth", "median_depth", "opacity", "static_rgb", "dynamic_rgb",
    "static_depth", "dynamic_depth", "static_opacity", "dynamic_opacity",
    "shadow_reduced_static_rgb", "shadow_only_static_rgb", "shadow",
    "shadow_ratio", "forward_flow", "backward_flow", "dino_feat",
    "dino_pe", "dino_pe_free", "static_dino", "dynamic_dino",
)
# ray keys the renderer reads
_RAY_KEYS = ("origins", "viewdirs", "normed_timestamps", "img_idx", "cam_idx",
             "pixel_coords")


class ImageRenderer:
    """Chunked full-image renderer on one device: the card unless the caller
    asks for another (raises where there is no card)."""

    def __init__(
        self,
        model,
        prop_models: Sequence,
        *,
        num_samples: int = 64,
        prop_samples: Sequence[int] = (128, 64),
        near_plane: float = 0.1,
        far_plane: float = 1000.0,
        sampling_type: str = "uniform_lindisp",
        chunk_size: int = 16384,
        return_decomposition: bool = False,
        sample_topk: int = 0,
        device="cuda",
        group=None,
    ):
        """``sample_topk``: shade only the K samples per ray that the last
        proposal net ranks highest (``render.eval_sample_topk``; exact top-K,
        no Gumbel noise); 0 shades every sample.  ``group``: shard each
        chunk over its ranks (``chunk_size`` must divide by their count;
        every rank calls the renderer with the same rays)."""
        if group is not None and chunk_size % dist.get_world_size(group):
            raise ValueError(f"chunk_size {chunk_size} not divisible by the "
                             f"{dist.get_world_size(group)} ranks")
        self._chunk = self.render_chunk if group is None else mesh.shard_render_chunk(
            self.render_chunk, group)
        self.model = model
        self.prop_models = list(prop_models)
        self.chunk_size = chunk_size
        self.device = resolve_device(device)
        self.kw = dict(
            num_samples=num_samples, prop_samples=tuple(prop_samples),
            near_plane=near_plane, far_plane=far_plane,
            sampling_type=sampling_type, return_decomposition=return_decomposition,
            sample_topk=sample_topk,
        )

    @torch.no_grad()
    def render_chunk(self, rays: Dict[str, torch.Tensor],
                     is_lidar: bool = False) -> Dict[str, torch.Tensor]:
        """One ray batch on the device; per-ray outputs without ``extras``.
        ``is_lidar``: the density-only lidar render, without decomposition."""
        kw = dict(self.kw, return_decomposition=False, is_lidar=True) if is_lidar else self.kw
        out = render_ray_batch(self.model, self.prop_models, rays, train=False, **kw).out
        out.pop("extras", None)
        return out

    def render_rays_chunked(self, rays: Dict[str, np.ndarray],
                            is_lidar: bool = False) -> Dict[str, np.ndarray]:
        """Render an arbitrary-length ray dict by padding to chunk_size
        (``is_lidar``: lidar rays, density only)."""
        n = rays["origins"].shape[0]
        chunk = self.chunk_size
        n_chunks = max((n + chunk - 1) // chunk, 1)
        pad = n_chunks * chunk - n
        padded = {}
        with span("eval.rays"):
            for k in _RAY_KEYS:
                if k in rays:
                    v = np.asarray(rays[k])
                    if pad:
                        v = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
                    padded[k] = torch.from_numpy(np.ascontiguousarray(v))
        outs: List[Dict[str, np.ndarray]] = []
        for i in range(n_chunks):
            with span("eval.chunk"):
                with span("eval.upload"):
                    sl = {k: v[i * chunk:(i + 1) * chunk].to(self.device)
                          for k, v in padded.items()}
                out = self._chunk(sl, is_lidar)
                # the first copy waits for the chunk's kernels
                with span("eval.fetch"):
                    outs.append({k: v.cpu().numpy() for k, v in out.items()})
        return {k: np.concatenate([o[k] for o in outs], axis=0)[:n] for k in outs[0]}

    def render_image(self, rays: Dict[str, np.ndarray], hw) -> Dict[str, np.ndarray]:
        """Render one image; per-ray outputs reshaped to (H, W, ...)."""
        out = self.render_rays_chunked(rays)
        h, w = hw
        maps = {}
        for k in _MAP_KEYS:
            if k in out:
                v = out[k].reshape(h, w, *out[k].shape[1:])
                if v.ndim == 3 and v.shape[-1] == 1:
                    v = v[..., 0]
                maps[k] = v
        return maps

    def render_split(self, dataset, indices: Sequence[int], downscale: int = 1,
                     compute_metrics: bool = True):
        """Render a list of dataset images; returns (frames, metrics)."""
        frames: List[Dict[str, np.ndarray]] = []
        psnrs, ssims, dyn_psnrs, stat_psnrs, dyn_ssims = [], [], [], [], []
        feat_psnrs, masked_feat_psnrs = [], []
        for idx in indices:
            with span("eval.frame"):
                with span("eval.rays"):
                    rays, gt = dataset.get_image_rays(int(idx), downscale=downscale)
                maps = self.render_image(rays, gt["hw"])
                maps["gt_rgb"] = gt["pixels"]
                if "dynamic_masks" in gt:
                    maps["gt_dynamic_mask"] = gt["dynamic_masks"]
                if "sky_masks" in gt:
                    maps["gt_sky_mask"] = gt["sky_masks"]
                frames.append(maps)
                if compute_metrics and "rgb" in maps:
                    with span("eval.metrics"):
                        psnrs.append(metrics.compute_psnr(maps["rgb"], gt["pixels"]))
                        ssim_mean, ssim_map = metrics.compute_ssim(
                            np.clip(maps["rgb"], 0, 1), np.clip(gt["pixels"], 0, 1), full=True)
                        ssims.append(ssim_mean)
                        if "dynamic_masks" in gt:
                            m = gt["dynamic_masks"] > 0.5
                            if m.sum() > 0:
                                dyn_psnrs.append(metrics.compute_psnr(maps["rgb"][m],
                                                                      gt["pixels"][m]))
                                dyn_ssims.append(float(ssim_map[m].mean()))
                            if (~m).sum() > 0:
                                stat_psnrs.append(metrics.compute_psnr(maps["rgb"][~m],
                                                                       gt["pixels"][~m]))
                        if "dino_feat" in maps and "features" in gt:
                            feat_psnrs.append(metrics.compute_psnr(maps["dino_feat"],
                                                                   gt["features"]))
                            if "dynamic_masks" in gt:
                                m = gt["dynamic_masks"] > 0.5
                                if m.sum() > 0:
                                    masked_feat_psnrs.append(metrics.compute_psnr(
                                        maps["dino_feat"][m], gt["features"][m]))
        out = {}
        if psnrs:
            out["psnr"] = float(np.mean(psnrs))
            out["ssim"] = float(np.mean(ssims))
        if dyn_psnrs:
            out["masked_psnr"] = float(np.mean(dyn_psnrs))
            out["masked_ssim"] = float(np.mean(dyn_ssims))
        if stat_psnrs:
            out["non_masked_psnr"] = float(np.mean(stat_psnrs))
        if feat_psnrs:
            out["feat_psnr"] = float(np.mean(feat_psnrs))
        if masked_feat_psnrs:
            out["masked_feat_psnr"] = float(np.mean(masked_feat_psnrs))
        return frames, out
