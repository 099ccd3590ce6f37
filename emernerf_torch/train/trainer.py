"""Training loop (port of the core of ``emernerf_tpu/train/trainer.py``).

Builds the dataset, the device-resident scene, the model and proposal nets,
the step config, the train state and the train step, then iterates: batch
sampling from an explicit ``torch.Generator``, the proposal requires-grad
schedule (called once per branch), the staged lidar top-K, the step, the
NaN tripwire at the print steps, and the pixel-error-buffer refresh every
``optim.cache_rgb_freq`` steps through the eval ``ImageRenderer``.

Not ported yet (ROADMAP queue 1): checkpoints, SIGTERM checkpoint-and-exit,
``--auto_resume``, wandb, the profiler window, the end-of-training
evaluation and the CLI.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from emernerf_torch import resolve_device
from emernerf_torch.builders import (
    build_dataset_from_cfg,
    build_model_from_cfg,
    build_propnets_from_cfg,
    build_train_step_config,
)
from emernerf_torch.config import ConfigNode
from emernerf_torch.data.scene import (
    draw_lidar,
    draw_pixel,
    sample_lidar_batch,
    sample_pixel_batch,
    update_pixel_error_map,
)
from emernerf_torch.eval.renderer import ImageRenderer
from emernerf_torch.render.prop_sampler import proposal_requires_grad_schedule
from emernerf_torch.train.state import init_train_state
from emernerf_torch.train.step import build_train_step, draw_step, lidar_full_at

logger = logging.getLogger("emernerf_torch")


def raise_on_nonfinite(scalars: Dict[str, float], step: int) -> None:
    """NaN tripwire over fetched metric scalars (losses and PSNR)."""
    bad = [k for k, v in scalars.items() if ("loss" in k or k == "psnr") and not np.isfinite(v)]
    if bad:
        raise RuntimeError(f"Non-finite loss detected at step {int(step)}: {bad} "
                           "(optim.check_nan=True)")


class Trainer:
    """One scene's training run on one device: the card unless the caller
    asks for another (raises where there is no card).  ``flow`` overrides
    the flow grid's spec (the tiny flagship's)."""

    def __init__(self, cfg: ConfigNode, device="cuda", flow=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        seed = int(cfg.optim.seed)
        init_gen = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

        self.dataset = build_dataset_from_cfg(cfg)
        self.scene = self.dataset.scene_tensors(self.device)
        self.model = build_model_from_cfg(cfg, self.dataset, device=self.device,
                                          generator=init_gen, flow=flow)
        self.prop_models = build_propnets_from_cfg(cfg, self.dataset, device=self.device,
                                                   generator=init_gen)
        self.step_cfg = build_train_step_config(cfg, self.dataset)
        self.state = init_train_state(self.model, self.prop_models)
        self.train_step = build_train_step(self.model, self.prop_models, self.step_cfg)
        self.ray_batch_size = cfg.data.ray_batch_size
        self.buffer_ratio = cfg.data.pixel_source.sampler.buffer_ratio
        self.buffer_downscale = cfg.data.pixel_source.sampler.buffer_downscale
        n_params = sum(p.numel() for p in self.state.params + self.state.prop_params)
        logger.info("Model parameters: %.2fM", n_params / 1e6)

        self.renderer = ImageRenderer(
            self.model, self.prop_models,
            num_samples=cfg.nerf.sampling.num_samples,
            prop_samples=tuple(cfg.nerf.propnet.num_samples_per_prop),
            near_plane=cfg.nerf.propnet.near_plane, far_plane=cfg.nerf.propnet.far_plane,
            sampling_type=cfg.nerf.propnet.sampling_type,
            chunk_size=cfg.render.render_chunk_size,
            return_decomposition=self.model.has_dynamic, device=self.device,
        )
        self.rg_fn = proposal_requires_grad_schedule()
        self.error_map_buffered = False

    # ---------------------------------------------------------------- #
    def _branch_draws(self, lidar: bool, full: bool = False):
        kw = self.train_step.render_kw(lidar, full)
        return draw_step(self.ray_batch_size, kw, self.model.has_dynamic, self.generator,
                         self.device)

    def train_iteration(self, step: int) -> Dict[str, torch.Tensor]:
        """One loop body at iteration ``step`` (the state's step)."""
        cfg = self.cfg
        gen = self.generator
        pixel_rg = self.rg_fn(step)
        ratio = self.buffer_ratio if self.error_map_buffered else 0.0
        pixel_batch = sample_pixel_batch(
            self.scene, draw_pixel(self.scene, self.ray_batch_size, gen, ratio,
                                   self.buffer_downscale),
            self.buffer_downscale, use_timestamps=self.model.has_dynamic)
        lidar_rg, lidar_batch, lidar_draws = False, None, None
        full = lidar_full_at(self.step_cfg, step)
        if self.step_cfg.has_lidar:
            lidar_rg = self.rg_fn(step)
            lidar_batch = sample_lidar_batch(self.scene,
                                             draw_lidar(self.scene, self.ray_batch_size, gen))
            lidar_draws = self._branch_draws(lidar=True, full=full)
        metrics = self.train_step(self.state, pixel_batch, lidar_batch,
                                  self._branch_draws(lidar=False), lidar_draws,
                                  pixel_rg, lidar_rg, full)
        metrics["pixel_rg"], metrics["lidar_rg"] = pixel_rg, lidar_rg
        if step % cfg.logging.print_freq == 0 or step == cfg.optim.num_iters:
            scalars = {k: float(v) for k, v in metrics.items()}
            logger.info("step %d: %s", step, scalars)
            if bool(cfg.optim.get("check_nan", False)):
                raise_on_nonfinite(scalars, step)
        if self.buffer_ratio > 0 and step > 0 and step % cfg.optim.cache_rgb_freq == 0:
            self._refresh_error_map()
        return metrics

    def train(self, num_iters: Optional[int] = None):
        """Iterate from the state's step to ``num_iters`` (default
        ``optim.num_iters``) inclusive, as the reference loop does."""
        last = self.cfg.optim.num_iters if num_iters is None else num_iters
        for step in range(self.state.step, last + 1):
            self.train_iteration(step)
        return self.state

    # ---------------------------------------------------------------- #
    def _refresh_error_map(self):
        """Refresh the pixel-error buffer from renders at the buffer's
        resolution; from then on a ``buffer_ratio`` share of each pixel batch
        is importance-sampled from it."""
        ds = self.buffer_downscale
        preds, gts, dyn_ops = [], [], []
        for idx in self.dataset.full_indices:
            rays, gt = self.dataset.get_image_rays(int(idx), downscale=ds)
            maps = self.renderer.render_image(rays, gt["hw"])
            preds.append(maps["rgb"])
            gts.append(gt["pixels"])
            if "dynamic_opacity" in maps:
                dyn_ops.append(maps["dynamic_opacity"])

        def dev(arrays):
            return torch.as_tensor(np.stack(arrays), device=self.device)

        self.scene = update_pixel_error_map(self.scene, dev(preds), dev(gts),
                                            dev(dyn_ops) if dyn_ops else None)
        self.error_map_buffered = True
