"""Whole-image evaluation rendering (port of ``emernerf_tpu/eval/renderer.py``).

Renders a dataset split image by image through fixed-size ray chunks (the
last chunk is padded by repeating its final ray), optionally shading only
the top-K samples per ray, collects the per-ray maps and computes PSNR/SSIM
(+ dynamic- and static-masked variants) and, with the feature head, the
PSNR of the lifted features against the feature maps (``feat_psnr``,
``masked_feat_psnr``): on the card with the image-metrics kernel
(``ops/image_metrics.py``) from the render's device outputs, elsewhere with
the numpy metrics of ``emernerf_torch/eval/metrics.py``.  With a process
group each rank
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
from emernerf_torch.ops import image_metrics
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
# render_split's metrics, in the order it reports them
_METRIC_KEYS = ("psnr", "ssim", "masked_psnr", "masked_ssim", "non_masked_psnr", "feat_psnr",
                "masked_feat_psnr")
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
        return self._render_chunked(rays, is_lidar)[0]

    def _render_chunked(self, rays: Dict[str, np.ndarray], is_lidar: bool = False,
                        keep: Sequence[str] = ()):
        """``render_rays_chunked``'s outputs, and the outputs named in
        ``keep`` also as (n, ...) float32 tensors on the device, each chunk's
        rows copied there before its fetch (the padding left out)."""
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
        kept: Dict[str, torch.Tensor] = {}
        for i in range(n_chunks):
            with span("eval.chunk"):
                with span("eval.upload"):
                    sl = {k: v[i * chunk:(i + 1) * chunk].to(self.device)
                          for k, v in padded.items()}
                out = self._chunk(sl, is_lidar)
                rows = min(chunk, n - i * chunk)
                for k in keep:
                    if k in out:
                        if k not in kept:
                            kept[k] = out[k].new_empty((n, *out[k].shape[1:]),
                                                       dtype=torch.float32)
                        kept[k][i * chunk:i * chunk + rows].copy_(out[k][:rows])
                # the first copy waits for the chunk's kernels
                with span("eval.fetch"):
                    outs.append({k: v.cpu().numpy() for k, v in out.items()})
        return {k: np.concatenate([o[k] for o in outs], axis=0)[:n] for k in outs[0]}, kept

    def render_image(self, rays: Dict[str, np.ndarray], hw) -> Dict[str, np.ndarray]:
        """Render one image; per-ray outputs reshaped to (H, W, ...)."""
        return self._render_image(rays, hw)[0]

    def _render_image(self, rays: Dict[str, np.ndarray], hw, keep: Sequence[str] = ()):
        """``render_image``'s maps, and those named in ``keep`` also as
        (H, W, ...) float32 device tensors (``_render_chunked``)."""
        out, kept = self._render_chunked(rays, keep=keep)
        h, w = hw
        maps = {}
        for k in _MAP_KEYS:
            if k in out:
                v = out[k].reshape(h, w, *out[k].shape[1:])
                if v.ndim == 3 and v.shape[-1] == 1:
                    v = v[..., 0]
                maps[k] = v
        return maps, {k: v.reshape(h, w, *v.shape[1:]) for k, v in kept.items()}

    def render_split(self, dataset, indices: Sequence[int], downscale: int = 1,
                     compute_metrics: bool = True):
        """Render a list of dataset images; returns (frames, metrics): each
        metric the mean of the frames'.  On the card the metrics are
        computed there (``ops/image_metrics.py``) from the render's device
        outputs; elsewhere in numpy on the fetched maps."""
        frames: List[Dict[str, np.ndarray]] = []
        per_frame: Dict[str, List[float]] = {k: [] for k in _METRIC_KEYS}
        on_card = compute_metrics and self.device.type == "cuda"
        for idx in indices:
            with span("eval.frame"):
                with span("eval.rays"):
                    rays, gt = dataset.get_image_rays(int(idx), downscale=downscale)
                maps, kept = self._render_image(rays, gt["hw"],
                                                keep=("rgb", "dino_feat") if on_card else ())
                maps["gt_rgb"] = gt["pixels"]
                if "dynamic_masks" in gt:
                    maps["gt_dynamic_mask"] = gt["dynamic_masks"]
                if "sky_masks" in gt:
                    maps["gt_sky_mask"] = gt["sky_masks"]
                frames.append(maps)
                if compute_metrics and "rgb" in maps:
                    with span("eval.metrics"):
                        frame = (self._card_metrics(kept, gt) if on_card
                                 else _host_metrics(maps, gt))
                    for k, v in frame.items():
                        per_frame[k].append(v)
        return frames, {k: float(np.mean(v)) for k, v in per_frame.items() if v}

    def _card_metrics(self, kept: Dict[str, torch.Tensor], gt) -> Dict[str, float]:
        """One frame's metrics by the image-metrics kernel, from the render's
        device maps and the ground truth uploaded once; one fetch of the
        sums."""
        def upload(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.device)

        h, w = gt["hw"]
        mask = upload(gt["dynamic_masks"] > 0.5, np.bool_) if "dynamic_masks" in gt else None
        win = image_metrics.ssim_window(h, w)
        sums = [image_metrics.image_metric_sums(kept["rgb"], upload(gt["pixels"]), mask, win)]
        feat = "dino_feat" in kept and "features" in gt
        if feat:
            sums.append(image_metrics.image_metric_sums(kept["dino_feat"],
                                                        upload(gt["features"]), mask))
        fetched = torch.stack(sums).cpu().tolist()
        out = image_metrics.frame_metrics(fetched[0], tuple(kept["rgb"].shape), win,
                                          masked=mask is not None)
        if feat:
            f = image_metrics.frame_metrics(fetched[1], tuple(kept["dino_feat"].shape), None,
                                            masked=mask is not None)
            out["feat_psnr"] = f["psnr"]
            if "masked_psnr" in f:
                out["masked_feat_psnr"] = f["masked_psnr"]
        return out


def _host_metrics(maps: Dict[str, np.ndarray], gt) -> Dict[str, float]:
    """One frame's metrics in numpy (``eval/metrics.py``) on the fetched maps."""
    rgb, pixels = maps["rgb"], gt["pixels"]
    out = {"psnr": metrics.compute_psnr(rgb, pixels)}
    out["ssim"], ssim_map = metrics.compute_ssim(np.clip(rgb, 0, 1), np.clip(pixels, 0, 1),
                                                 full=True)
    m = gt["dynamic_masks"] > 0.5 if "dynamic_masks" in gt else None
    if m is not None and m.sum() > 0:
        out["masked_psnr"] = metrics.compute_psnr(rgb[m], pixels[m])
        out["masked_ssim"] = float(ssim_map[m].mean())
    if m is not None and (~m).sum() > 0:
        out["non_masked_psnr"] = metrics.compute_psnr(rgb[~m], pixels[~m])
    if "dino_feat" in maps and "features" in gt:
        out["feat_psnr"] = metrics.compute_psnr(maps["dino_feat"], gt["features"])
        if m is not None and m.sum() > 0:
            out["masked_feat_psnr"] = metrics.compute_psnr(maps["dino_feat"][m],
                                                           gt["features"][m])
    return out
