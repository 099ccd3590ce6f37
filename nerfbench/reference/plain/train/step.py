"""The training step (port of ``emernerf_tpu/train/step.py``).

One iteration, as the reference runs it: the pixel branch (render, pixel
losses + interlevel loss, backward, Adam at scheduler count 2*step), then
the lidar branch on the updated params (render, depth + line-of-sight
losses + interlevel loss, backward, Adam at count 2*step + 1).  The
proposal nets are updated only on requires-grad renders.

Random draws are inputs: each branch takes a :class:`StepDraws` (the
stratified jitters, the Gumbel uniforms of the top-K sample selection and
the aggregation noise).  The trainer fills it from its generator; the
parity tests fill it with the values JAX drew.

``remat`` recomputes each render's field query in its backward
(``render_ray_batch(..., remat=True)``).  The port's fused pixel + lidar
branch (``optim.fused_lidar_branch``) and its data-parallel step are left
out: no configuration of the benchmark runs them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from nerfbench.reference.plain.losses.losses import (
    cycle_consistency_loss,
    depth_loss,
    dynamic_regularization_loss,
    line_of_sight_loss,
    real_value_loss,
    sky_loss_opacity,
    sky_loss_weights,
)
from nerfbench.reference.plain.render.prop_sampler import compute_prop_loss
from nerfbench.reference.plain.render.renderer import render_ray_batch
from nerfbench.reference.plain.train.optim import apply_update, chained_lr_schedule, make_adam
from nerfbench.reference.plain.train.state import TrainState


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    """Static hyperparameters of one training step; the fields and defaults
    of the reference's ``TrainStepConfig``."""

    # sampling
    num_samples: int = 64
    prop_samples: Tuple[int, ...] = (128, 64)
    near_plane: float = 0.1
    far_plane: float = 1000.0
    sampling_type: str = "uniform_lindisp"
    enable_anti_aliasing: bool = True
    pulse_widths: Tuple[float, ...] = (0.03, 0.003)
    prop_loss_scaler: float = 1024.0
    # supervision
    rgb_loss_type: str = "l2"
    rgb_coef: float = 1.0
    use_sky_loss: bool = False
    sky_loss_type: str = "opacity_based"
    sky_coef: float = 0.001
    use_feature_loss: bool = False
    feature_loss_type: str = "l2"
    feature_coef: float = 0.5
    use_dynamic_reg: bool = False
    dynamic_loss_type: str = "sparsity"
    dynamic_coef: float = 0.01
    entropy_skewness: float = 1.1
    use_shadow_loss: bool = False
    shadow_loss_type: str = "sparsity"
    shadow_coef: float = 0.01
    cycle_coef: float = 0.01
    has_flow: bool = False
    # lidar supervision
    has_lidar: bool = False
    depth_loss_type: str = "l2"
    depth_coef: float = 1.0
    depth_upper_bound: float = 80.0
    los_enable: bool = True
    los_coef: float = 0.1
    los_start_iter: int = 2000
    los_start_epsilon: float = 6.0
    los_end_epsilon: float = 2.5
    los_decay_steps: int = 5000
    los_decay_rate: float = 0.5
    # optimization
    lr: float = 0.01
    weight_decay: float = 1e-5
    num_iters: int = 25000
    remat: bool = False
    fused_branches: bool = False
    # top-K sample pruning (0 = off), its Gumbel temperature, the lidar
    # branch's own K (-1 = sample_topk), the fraction of the schedule after
    # which the lidar branch renders unpruned, and its own proposal counts
    sample_topk: int = 0
    sample_topk_temp: float = 0.0
    lidar_sample_topk: int = -1
    lidar_topk_until: float = 1.0
    lidar_prop_samples: Optional[Tuple[int, ...]] = None


class StepDraws(NamedTuple):
    """One branch's random draws."""

    jitters: Tuple[torch.Tensor, ...]  # per sampling step, (R, 1) in [-pad, pad]
    topk_u: Optional[torch.Tensor]  # (R, S) uniforms for the Gumbel top-K, or None
    agg_noise: Optional[torch.Tensor]  # (R, S_q, 1) aggregation noise, or None


def draw_step(n_rays: int, render_kw: Dict, with_agg: bool,
              generator: torch.Generator, device=None) -> StepDraws:
    """The draws one branch's render consumes, from ``generator``."""
    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    jitters = []
    for n in (*render_kw["prop_samples"], render_kw["num_samples"]):
        pad = 1.0 / (2 * (n + 1))
        jitters.append(rand(n_rays, 1) * (2.0 * pad) - pad)
    s, k = render_kw["num_samples"], render_kw["sample_topk"]
    prune = 0 < k < s
    topk_u = rand(n_rays, s) if prune and render_kw["sample_topk_temp"] > 0 else None
    agg = rand(n_rays, k if prune else s, 1) if with_agg else None
    return StepDraws(tuple(jitters), topk_u, agg)


def psnr_of_mse(mse):
    return -10.0 * torch.log10(mse.clamp_min(1e-10))


def los_epsilon(cfg: TrainStepConfig, step: int) -> float:
    """Linear epsilon decay from start to end over the rest of the schedule,
    in float32 as the reference computes it."""
    m = (cfg.los_end_epsilon - cfg.los_start_epsilon) / max(cfg.num_iters - cfg.los_start_iter, 1)
    b = cfg.los_start_epsilon - m * cfg.los_start_iter
    eps = np.float32(m) * np.float32(step) + np.float32(b)
    lo = min(cfg.los_start_epsilon, cfg.los_end_epsilon)
    hi = max(cfg.los_start_epsilon, cfg.los_end_epsilon)
    return float(np.clip(eps, np.float32(lo), np.float32(hi)))


def los_decay_weight(cfg: TrainStepConfig, step: int) -> float:
    """x decay_rate every decay_steps past start_iter."""
    n = max(step - cfg.los_start_iter, 0) // cfg.los_decay_steps
    return float(np.float32(cfg.los_decay_rate) ** np.float32(n))


class TrainStep:
    """``step(state, pixel_batch, lidar_batch, pixel_draws, lidar_draws,
    pixel_rg, lidar_rg, lidar_full) -> metrics``; updates ``state`` in place.

    Batches are dicts of device tensors:
      pixel: origins, viewdirs, pixels + optional sky_masks, features,
             normed_timestamps, img_idx, cam_idx, pixel_coords
      lidar: origins, viewdirs, ranges, normed_timestamps
    """

    def __init__(self, model, prop_models: Sequence, cfg: TrainStepConfig):
        self.model, self.prop_models, self.cfg = model, list(prop_models), cfg
        self.tx = make_adam(cfg.weight_decay)
        self.lr_fn = chained_lr_schedule(cfg.lr, cfg.num_iters)
        self.steps_per_iter = 2 if cfg.has_lidar else 1
        kw = dict(num_samples=cfg.num_samples, prop_samples=tuple(cfg.prop_samples),
                  near_plane=cfg.near_plane, far_plane=cfg.far_plane,
                  sampling_type=cfg.sampling_type, sample_topk=cfg.sample_topk,
                  sample_topk_temp=cfg.sample_topk_temp)
        lidar = dict(kw, sample_topk=(cfg.lidar_sample_topk if cfg.lidar_sample_topk >= 0
                                      else cfg.sample_topk),
                     prop_samples=tuple(cfg.lidar_prop_samples or cfg.prop_samples))
        self._kw = {(False, False): kw, (True, False): lidar,
                    (True, True): dict(lidar, sample_topk=0)}

    def render_kw(self, lidar: bool = False, full: bool = False) -> Dict:
        """The render settings of a branch (``full``: the unpruned lidar)."""
        return self._kw[(lidar, lidar and full)]

    # ---------------- pixel branch ---------------- #
    def _pixel_losses(self, out, extras, batch) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        losses = {"rgb_loss": real_value_loss(out["rgb"], batch["pixels"], cfg.rgb_loss_type,
                                              cfg.rgb_coef)}
        if cfg.use_sky_loss:
            if cfg.sky_loss_type == "opacity_based":
                losses["sky_loss"] = sky_loss_opacity(out["opacity"], batch["sky_masks"],
                                                      cfg.sky_coef)
            else:
                losses["sky_loss"] = sky_loss_weights(extras["weights"], batch["sky_masks"],
                                                      cfg.sky_coef)
        if cfg.use_feature_loss:
            losses["feature_loss"] = real_value_loss(out["dino_feat"], batch["features"],
                                                     cfg.feature_loss_type, cfg.feature_coef)
        if cfg.use_dynamic_reg:
            losses["dynamic_reg_loss"] = dynamic_regularization_loss(
                extras["dynamic_density"], extras["static_density"],
                loss_type=cfg.dynamic_loss_type, coef=cfg.dynamic_coef,
                entropy_skewness=cfg.entropy_skewness)
        if cfg.use_shadow_loss:
            losses["shadow_loss"] = dynamic_regularization_loss(
                out["shadow_ratio"], loss_type=cfg.shadow_loss_type, coef=cfg.shadow_coef)
        if cfg.has_flow:
            losses["cycle_loss"] = cycle_consistency_loss(
                extras["forward_flow"], extras["forward_pred_backward_flow"],
                extras["backward_flow"], extras["backward_pred_forward_flow"],
                cfg.cycle_coef, mask=extras.get("agg_mask"))
        return losses

    def _render(self, batch, draws: StepDraws, requires_grad: bool, lidar: bool,
                full: bool = False):
        return render_ray_batch(
            self.model, self.prop_models, batch, jitters=draws.jitters,
            requires_grad=requires_grad, is_lidar=lidar, topk_u=draws.topk_u,
            agg_noise=draws.agg_noise, train=True, remat=self.cfg.remat,
            **self.render_kw(lidar, full))

    def _prop_loss(self, res, requires_grad: bool):
        if not requires_grad:
            return res.s_vals.new_zeros(())
        cfg = self.cfg
        return compute_prop_loss(res.caches, res.s_vals, res.out["extras"]["trans"],
                                 cfg.enable_anti_aliasing, tuple(cfg.pulse_widths),
                                 cfg.prop_loss_scaler)

    def pixel_loss(self, batch, draws: StepDraws, step: int, requires_grad: bool):
        """(total loss, aux metrics) of the pixel branch."""
        res = self._render(batch, draws, requires_grad, lidar=False)
        out = res.out
        losses = self._pixel_losses(out, out["extras"], batch)
        prop_loss = self._prop_loss(res, requires_grad)
        total = sum(losses.values()) + prop_loss
        aux = dict(losses)
        aux["prop_loss"] = prop_loss
        mse = ((out["rgb"] - batch["pixels"]) ** 2).mean()
        aux["psnr"] = psnr_of_mse(mse)
        aux["total_pixel_loss"] = sum(losses.values())
        return total, aux

    # ---------------- lidar branch ---------------- #
    def _lidar_losses(self, out, extras, batch, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        losses = {"lidar_range_loss": depth_loss(out["depth"], batch["ranges"],
                                                 cfg.depth_loss_type, cfg.depth_coef,
                                                 cfg.depth_upper_bound)}
        if cfg.los_enable:
            # active only after the warm-up iterations
            if step > cfg.los_start_iter:
                losses["lidar_line_of_sight"] = line_of_sight_loss(
                    batch["ranges"], extras["weights"], extras["t_vals"],
                    los_epsilon(cfg, step), cfg.los_coef, los_decay_weight(cfg, step))
            else:
                losses["lidar_line_of_sight"] = out["depth"].new_zeros(())
        if cfg.use_dynamic_reg:
            losses["lidar_dynamic_loss"] = dynamic_regularization_loss(
                extras["dynamic_density"], extras["static_density"],
                loss_type=cfg.dynamic_loss_type, coef=cfg.dynamic_coef,
                entropy_skewness=cfg.entropy_skewness)
        return losses

    def lidar_loss(self, batch, draws: StepDraws, step: int, requires_grad: bool,
                   full: bool = False):
        """(total loss, aux metrics) of the lidar branch."""
        res = self._render(batch, draws, requires_grad, lidar=True, full=full)
        out = res.out
        losses = self._lidar_losses(out, out["extras"], batch, step)
        total = sum(losses.values()) + self._prop_loss(res, requires_grad)
        aux = dict(losses)
        aux["total_lidar_loss"] = sum(losses.values())
        aux["range_rmse"] = torch.sqrt(((out["depth"][..., 0] - batch["ranges"]) ** 2).mean())
        return total, aux

    # ---------------- one branch: backward + updates ---------------- #
    def _apply_branch(self, state: TrainState, total, requires_grad: bool, count: int) -> float:
        params, prop_params = state.params, state.prop_params
        total.backward()
        lr = self.lr_fn(count)
        # (params, moments): the proposal nets only on requires-grad renders
        parts = [(prop_params, state.prop_opt_state)] if requires_grad else []
        parts.append((params, state.opt_state))
        for ps, opt in parts:
            apply_update(self.tx, [p.grad for p in ps], opt, ps, lr)
        for p in params + prop_params:
            p.grad = None
        return lr

    def __call__(self, state: TrainState, pixel_batch, lidar_batch, pixel_draws: StepDraws,
                 lidar_draws: Optional[StepDraws], pixel_rg: bool, lidar_rg: bool,
                 lidar_full: bool = False) -> Dict[str, torch.Tensor]:
        step = state.step
        count = step * self.steps_per_iter
        for p in state.params + state.prop_params:
            p.grad = None
        total, aux = self.pixel_loss(pixel_batch, pixel_draws, step, pixel_rg)
        lr = self._apply_branch(state, total, pixel_rg, count)
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics["lr"] = lr
        if self.cfg.has_lidar:
            total, laux = self.lidar_loss(lidar_batch, lidar_draws, step, lidar_rg, lidar_full)
            self._apply_branch(state, total, lidar_rg, count + 1)
            metrics.update({k: v.detach() for k, v in laux.items()})
        state.step = step + 1
        return metrics


def build_train_step(model, prop_models: Sequence, cfg: TrainStepConfig) -> TrainStep:
    """The train step for ``model`` and ``prop_models`` on one device."""
    if cfg.fused_branches:
        raise NotImplementedError("the fused pixel + lidar branch is not in the reference: "
                                  "no configuration of the benchmark runs it")
    return TrainStep(model, prop_models, cfg)


def lidar_full_at(cfg: TrainStepConfig, it: int) -> bool:
    """Host-side staged lidar-K schedule: True once ``it`` passes
    ``lidar_topk_until`` of the run (and staging is active)."""
    return (
        cfg.has_lidar
        and cfg.lidar_topk_until < 1.0
        and (cfg.lidar_sample_topk > 0 or cfg.sample_topk > 0)
        and it >= cfg.lidar_topk_until * cfg.num_iters
    )
