"""Training orchestration (port of ``emernerf_tpu/train/trainer.py``).

Builds the dataset, the device-resident scene, the model and proposal nets,
the step config, the train state and the train step, then iterates: batch
sampling from an explicit ``torch.Generator``, the proposal requires-grad
schedule (called once per branch), the staged lidar top-K, the step, the
metric log and NaN tripwire at the print steps, periodic checkpoints, the
pixel-error-buffer refresh every ``optim.cache_rgb_freq`` steps through the
eval ``ImageRenderer``, a ``torch.profiler`` window (with the port's spans,
``utils/trace.py``, as ``record_function`` rows), and SIGTERM/SIGINT
checkpoint-and-exit.  ``evaluate`` runs the few-shot occupancy evaluation
and the lidar scene-flow evaluation, renders the configured splits and the
novel trajectory, and writes the metric JSONs, the lidar depth RMSE and
the videos (where ``imageio`` is installed).

Not ported yet (ROADMAP queue 1): the multi-device mesh; it raises.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

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
from emernerf_torch.eval.flow import evaluate_lidar_flow
from emernerf_torch.eval.metrics import compute_valid_depth_rmse
from emernerf_torch.eval.novel import render_novel_trajectory
from emernerf_torch.eval.occ import run_occ_eval
from emernerf_torch.eval.points import PointQueryEngine
from emernerf_torch.eval.renderer import ImageRenderer
from emernerf_torch.eval.video import have_imageio, save_videos
from emernerf_torch.parallel import mesh
from emernerf_torch.parallel.spmd import SpmdConfig, shard_state
from emernerf_torch.render.prop_sampler import proposal_requires_grad_schedule
from emernerf_torch.train.checkpoints import load_checkpoint, save_checkpoint
from emernerf_torch.train.state import init_train_state
from emernerf_torch.train.step import StepDraws, build_train_step, draw_step, lidar_full_at
from emernerf_torch.utils.logging import MetricLogger
from emernerf_torch.utils import trace

logger = logging.getLogger("emernerf_torch")


def raise_on_nonfinite(scalars: Dict[str, float], step: int) -> None:
    """NaN tripwire over fetched metric scalars (losses and PSNR)."""
    bad = [k for k, v in scalars.items() if ("loss" in k or k == "psnr") and not np.isfinite(v)]
    if bad:
        raise RuntimeError(f"Non-finite loss detected at step {int(step)}: {bad} "
                           "(optim.check_nan=True)")


def init_wandb(cfg: ConfigNode, log_dir: str, retries: int = 10, sleep_s: float = 1.0):
    """wandb.init with a retry loop for flaky machines; returns the module or
    None (a logging outage must not kill a 25k-iteration run).  Without the
    package it is off at once, without a retry."""
    for attempt in range(retries):
        try:
            import wandb

            wandb.init(project=cfg.get("project", "emernerf_torch"),
                       entity=cfg.get("wandb_entity", None), name=cfg.get("run_name", None),
                       dir=log_dir, config=cfg.to_dict())
            return wandb
        except ImportError as e:
            logger.warning("wandb disabled: %s", e)
            return None
        except Exception as e:
            logger.warning("wandb init failed (attempt %d/%d): %s", attempt + 1, retries, e)
            time.sleep(sleep_s)
    logger.warning("wandb disabled after %d failed init attempts", retries)
    return None


def spmd_config(cfg: ConfigNode) -> Optional[SpmdConfig]:
    """The explicit-collective settings of ``parallel.*``, or None for the
    implicit path (``explicit_collectives: false``)."""
    if not bool(cfg.get_dotted("parallel.explicit_collectives", True)):
        return None
    return SpmdConfig(grad_psum_dtype=str(cfg.get_dotted("parallel.grad_psum_dtype", "bfloat16")),
                      zero=bool(cfg.get_dotted("parallel.zero", True)),
                      direction_dtype=str(cfg.get_dotted("parallel.direction_dtype", "bfloat16")))


def check_parallel(cfg: ConfigNode, n: int) -> None:
    """Batch and chunk sizes must split evenly over ``n`` ranks."""
    for key in ("data.ray_batch_size", "render.render_chunk_size"):
        if int(cfg.get_dotted(key)) % n:
            raise ValueError(f"{key} {cfg.get_dotted(key)} must divide by "
                             f"parallel.num_devices {n}")


class Trainer:
    """One scene's training run on one device: the card unless the caller
    asks for another (raises where there is no card).  ``log_dir`` receives
    ``metrics.json``, the checkpoints, the buffer maps, the profile and the
    evaluation JSONs; without it the run writes no files.  ``flow``
    overrides the flow grid's spec (the tiny flagship's).  With
    ``parallel.num_devices`` other than 1, ``group`` is the process group
    of that many ranks (``parallel.mesh.init_data_parallel``) and this
    trainer is one of them."""

    def __init__(self, cfg: ConfigNode, log_dir: Optional[str] = None,
                 enable_wandb: bool = False, device="cuda", flow=None, group=None):
        self.cfg = cfg
        self.log_dir = log_dir
        self.device = resolve_device(device)
        n = int(cfg.get_dotted("parallel.num_devices", 1))
        if group is None:
            n = mesh.world_size(n, self.device)
        elif n == 0:  # every rank of the group
            n = dist.get_world_size(group)
        if n != 1 and (group is None or dist.get_world_size(group) != n):
            raise ValueError(f"parallel.num_devices={n} needs a process group of {n} ranks "
                             "(the CLI starts them; see parallel.mesh.init_data_parallel)")
        self.group = group if n > 1 else None
        self.rank, self.n_ranks = mesh.rank_and_size(self.group) if self.group else (0, 1)
        self.is_main = self.rank == 0
        if self.group is not None:
            check_parallel(cfg, n)
            logger.info("Data-parallel rank %d of %d on %s", self.rank, n, self.device)
        seed = int(cfg.optim.seed)
        init_gen = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.wandb = init_wandb(cfg, log_dir) if enable_wandb and self.is_main else None

        self.dataset = build_dataset_from_cfg(cfg, self.device)
        logger.info("Dataset: %d images (%d train / %d test), aabb=%s",
                    self.dataset.num_images, len(self.dataset.train_indices),
                    len(self.dataset.test_indices), self.dataset.aabb)
        self.scene = self.dataset.scene_tensors(self.device)
        self.model = build_model_from_cfg(cfg, self.dataset, device=self.device,
                                          generator=init_gen, flow=flow)
        self.prop_models = build_propnets_from_cfg(cfg, self.dataset, device=self.device,
                                                   generator=init_gen)
        self.step_cfg = build_train_step_config(cfg, self.dataset)
        logger.info("Train step config: %s", self.step_cfg)
        self.state = init_train_state(self.model, self.prop_models)
        spmd = spmd_config(cfg) if self.group is not None else None
        if spmd is not None:
            shard_state(self.state, spmd, self.group)
        self.train_step = build_train_step(self.model, self.prop_models, self.step_cfg,
                                           self.group, spmd)
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
            return_decomposition=self.model.has_dynamic,
            sample_topk=int(cfg.get_dotted("render.eval_sample_topk", 0)), device=self.device,
            group=self.group,
        )
        self.rg_fn = proposal_requires_grad_schedule()
        self.error_map_buffered = False
        self.metric_logger = MetricLogger(delimiter="  ")

        self.start_step = 0
        self.preempted = False
        if cfg.resume_from:
            load_checkpoint(cfg.resume_from, self.state)
            self.start_step = self.state.step
            logger.info("Resumed from %s at step %d", cfg.resume_from, self.start_step)

    def _path(self, *names) -> Optional[str]:
        """A file under the log dir: None without one and on ranks but 0."""
        if self.log_dir is None or not self.is_main:
            return None
        return os.path.join(self.log_dir, *names)

    def _barrier(self) -> None:
        if self.group is not None:
            dist.barrier(self.group)

    def save(self) -> Optional[str]:
        """A checkpoint of the state at its step (none without a log dir),
        written by rank 0; every rank joins the gather of ZeRO moments."""
        if self.log_dir is None:
            return None
        path = save_checkpoint(self._path(), self.state)
        self._barrier()
        return path

    # ---------------------------------------------------------------- #
    def _slice(self, tensor):
        """This rank's slice of a whole batch's tensor."""
        if self.group is None or tensor is None:
            return tensor
        return mesh.batch_slice(tensor, self.rank, self.n_ranks)

    def _branch_draws(self, lidar: bool, full: bool = False, batches: int = 1) -> StepDraws:
        """One render's draws, this rank's slice: of one batch, or (the fused
        branch, ``batches`` = 2) of the pixel and the lidar batch one after
        the other."""
        kw = self.train_step.render_kw(lidar, full)
        d = draw_step(batches * self.ray_batch_size, kw, self.model.has_flow, self.generator,
                      self.device)

        def cut(t):
            if t is None or batches == 1:
                return self._slice(t)
            return torch.cat([self._slice(part) for part in t.split(self.ray_batch_size)])

        return StepDraws(tuple(map(cut, d.jitters)), cut(d.topk_u), cut(d.agg_noise))

    def train_iteration(self, step: int) -> Dict[str, torch.Tensor]:
        """One loop body at iteration ``step`` (the state's step)."""
        with trace.span("trainer.iteration"):
            cfg = self.cfg
            gen = self.generator
            with trace.span("trainer.sample"):
                pixel_rg = self.rg_fn(step)
                ratio = self.buffer_ratio if self.error_map_buffered else 0.0
                pixel_batch = sample_pixel_batch(
                    self.scene, draw_pixel(self.scene, self.ray_batch_size, gen, ratio,
                                           self.buffer_downscale),
                    self.buffer_downscale, use_timestamps=self.model.has_dynamic)
                pixel_batch = {k: self._slice(v) for k, v in pixel_batch.items()}
                lidar_rg, lidar_batch, lidar_draws = False, None, None
                full = lidar_full_at(self.step_cfg, step)
                # the fused branch renders both batches at once, with one set of draws
                fused = self.step_cfg.fused_branches and self.step_cfg.has_lidar
                if self.step_cfg.has_lidar:
                    lidar_rg = self.rg_fn(step)
                    lidar_batch = sample_lidar_batch(
                        self.scene, draw_lidar(self.scene, self.ray_batch_size, gen))
                    lidar_batch = {k: self._slice(v) for k, v in lidar_batch.items()}
                    if not fused:
                        lidar_draws = self._branch_draws(lidar=True, full=full)
                pixel_draws = self._branch_draws(lidar=False, batches=2 if fused else 1)
            metrics = self.train_step(self.state, pixel_batch, lidar_batch, pixel_draws,
                                      lidar_draws, pixel_rg, lidar_rg, full)
            metrics["pixel_rg"], metrics["lidar_rg"] = pixel_rg, lidar_rg
            if step % cfg.logging.print_freq == 0 or step == cfg.optim.num_iters:
                with trace.span("trainer.log"):
                    scalars = {k: float(v) for k, v in metrics.items()}
                    logger.info("step %d: %s", step, scalars)
                    self.metric_logger.update(**scalars)
                    if self.wandb is not None:
                        self.wandb.log(scalars, step=int(step))
                    if bool(cfg.optim.get("check_nan", False)):
                        raise_on_nonfinite(scalars, step)
            if self.buffer_ratio > 0 and step > 0 and step % cfg.optim.cache_rgb_freq == 0:
                with trace.span("trainer.refresh"):
                    self._refresh_error_map()
            return metrics

    def train(self, num_iters: Optional[int] = None):
        """Iterate from the state's step to ``num_iters`` (default
        ``optim.num_iters``) inclusive, as the reference loop does, then save
        the final checkpoint.

        The first SIGTERM/SIGINT (``optim.checkpoint_on_preempt``) asks for a
        clean stop: the in-flight iteration finishes, a checkpoint of its
        step is saved, ``preempted`` is set and the loop returns; the
        previous handlers come back on first receipt (a second signal acts
        the default way) and on every way out of the loop.  With several
        ranks the flag is all-reduced each iteration: a signal to any rank
        stops all of them at the same step."""
        cfg = self.cfg
        last = cfg.optim.num_iters if num_iters is None else num_iters
        self.metric_logger = MetricLogger(delimiter="  ", output_file=self._path("metrics.json"))
        prof_start = int(cfg.logging.get("profiling_start_iter", -1))
        prof_iters = int(cfg.logging.get("profiling_num_iters", 5))
        profiler = None

        stop_signal: list = []
        prev_handlers: dict = {}

        def _request_stop(signum, frame):
            stop_signal.append(signum)
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)

        if bool(cfg.optim.get("checkpoint_on_preempt", True)):
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    prev_handlers[sig] = signal.signal(sig, _request_stop)
                except ValueError:
                    # only the main thread may set handlers; a trainer driven
                    # from another thread goes without this feature
                    prev_handlers.clear()
                    break

        try:
            steps = range(self.state.step, last + 1)
            for step in self.metric_logger.log_every(steps, cfg.logging.print_freq):
                if self._stop_requested(stop_signal):
                    path = self.save()
                    logger.info("Preempted (signal %s) at step %d: saved %s; exiting cleanly",
                                stop_signal[0] if stop_signal else "on another rank",
                                self.state.step, path)
                    # the caller skips the end-of-training evaluation: a
                    # preemption grace window cannot afford a render pass
                    self.preempted = True
                    return self.state
                if prof_start >= 0 and step == prof_start and self._path() is not None:
                    profiler = self._start_profiler()
                self.train_iteration(step)
                if profiler is not None and step == prof_start + prof_iters:
                    self._stop_profiler(profiler, step)
                    profiler = None
                if (step > 0 and cfg.logging.saveckpt_freq > 0
                        and step % cfg.logging.saveckpt_freq == 0
                        # the reference's quirk: a hand-set resume_from never
                        # saves; --auto_resume does, or restart cycles would
                        # stop persisting progress
                        and (not cfg.resume_from or bool(cfg.get("auto_resumed", False)))):
                    logger.info("Saved checkpoint: %s", self.save())
            logger.info("Saved final checkpoint: %s", self.save())
            return self.state
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
            if profiler is not None:
                if self._profiler_spans:
                    trace.disable()
                profiler.stop()

    def _stop_requested(self, stop_signal: list) -> bool:
        """Whether this rank, or with several ranks any rank, caught a stop
        signal."""
        if self.group is None:
            return bool(stop_signal)
        flag = torch.tensor([float(bool(stop_signal))],
                            device="cpu" if dist.get_backend(self.group) == "gloo"
                            else self.device)
        return bool(mesh.all_reduce_(flag, self.group, dist.ReduceOp.MAX).item())

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        # the spans over the kernels in the chrome trace, unless their
        # records belong to a caller that turned tracing on already
        self._profiler_spans = not trace.enabled()
        if self._profiler_spans:
            trace.enable(annotate=True)
        logger.info("Started torch.profiler -> %s", self._path("profile"))
        return prof

    def _stop_profiler(self, prof, step: int):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self._profiler_spans:
            trace.disable()
        prof.stop()
        os.makedirs(self._path("profile"), exist_ok=True)
        path = self._path("profile", f"trace_{step:05d}.json")
        prof.export_chrome_trace(path)
        logger.info("Stopped torch.profiler at step %d: %s", step, path)

    # ---------------------------------------------------------------- #
    def _refresh_error_map(self):
        """Refresh the pixel-error buffer from renders at the buffer's
        resolution; from then on a ``buffer_ratio`` share of each pixel batch
        is importance-sampled from it.  The maps are dumped under
        ``buffer_maps/``."""
        logger.info("Refreshing pixel error buffer...")
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
        if self._path() is not None:
            os.makedirs(self._path("buffer_maps"), exist_ok=True)
            np.save(self._path("buffer_maps", f"buffer_{self.state.step:05d}.npy"),
                    self.scene.pixel_error_map.cpu().numpy().astype(np.float16))

    # ---------------------------------------------------------------- #
    def _write_json(self, name: str, obj) -> None:
        if self._path() is not None:
            with open(self._path(name), "w") as f:
                json.dump(obj, f, indent=2)

    def _occ_eval(self) -> Optional[Dict]:
        """The few-shot occupancy metrics (``eval.eval_occ``), or None with a
        warning where the scene has no Occ3D annotations."""
        if not hasattr(self.dataset, "ego_to_worlds"):
            logger.warning("eval_occ=True but the dataset has no ego poses / Occ3D annotations "
                           "(only the Waymo loader provides them); skipping occupancy eval")
            return None
        try:
            return run_occ_eval(self.dataset, PointQueryEngine(self.model, device=self.device),
                                annotation_stride=self.cfg.eval.occ_annotation_stride)
        except FileNotFoundError as e:
            logger.warning("eval_occ=True but Occ3D annotations missing: %s", e)
            return None

    def evaluate(self) -> Dict[str, float]:
        """End-of-training evaluation at the state's step: the few-shot
        occupancy metrics (``eval.eval_occ``), the lidar scene-flow metrics
        (``eval.eval_lidar_flow``), the configured splits (``lowres``,
        ``test``, ``full``), the novel trajectory
        (``render.render_novel_trajectory``) and a few frames' lidar depth.
        Writes ``metrics_occ_{step}.json``, ``metrics_flow_{step}.json``,
        ``metrics_{split}_{step}.json`` and ``metrics_all_{step}.json``, and
        the videos under ``videos/`` where ``imageio`` is installed (without
        it, one warning)."""
        cfg = self.cfg
        step = self.state.step
        results: Dict[str, float] = {}
        video_dir = self._path("videos")
        write_videos = video_dir is not None and have_imageio()
        if video_dir is not None:
            os.makedirs(video_dir, exist_ok=True)
            if not write_videos:
                logger.warning("imageio is not installed: the evaluation writes no videos")

        def _save(frames, name, **kw):
            if write_videos:
                save_videos(frames, os.path.join(video_dir, name), **kw)

        # the point-query evaluations run on rank 0 alone; the renders below
        # are sharded and every rank joins them
        if cfg.eval.eval_occ and self.is_main:
            occ_metrics = self._occ_eval()
            if occ_metrics is not None:
                # the scalar metrics (not the per-class dict)
                for k, v in occ_metrics.items():
                    if np.isscalar(v):
                        results[f"occ/{k}"] = float(v)
                self._write_json(f"metrics_occ_{step}.json", occ_metrics)
                logger.info("[occ] %s", occ_metrics)

        if (cfg.eval.eval_lidar_flow and self.model.has_flow and self.dataset.lidar is not None
                and "flows" in self.dataset.lidar and self.is_main):
            flow_metrics = evaluate_lidar_flow(
                PointQueryEngine(self.model, device=self.device), self.dataset,
                remove_ground=cfg.eval.remove_ground_when_eval_lidar_flow)
            for k, v in flow_metrics.items():
                results[f"flow/{k}"] = v
            self._write_json(f"metrics_flow_{step}.json", flow_metrics)
            logger.info("[flow] %s", flow_metrics)

        vis_keys = ["gt_rgb", "rgb", "depth"]
        if self.model.has_dynamic:
            vis_keys += ["static_rgb", "dynamic_rgb", "dynamic_depth"]
        if self.model.has_flow:
            vis_keys += ["forward_flow", "backward_flow"]
        if self.model.enable_feature_head:
            vis_keys += ["dino_feat"]

        def _run(split_name, indices, downscale):
            if len(indices) == 0:
                return
            frames, metrics = self.renderer.render_split(self.dataset, indices,
                                                         downscale=downscale)
            for k, v in metrics.items():
                results[f"{split_name}/{k}"] = v
            n_t = len(indices) // self.dataset.num_cams
            _save(frames, f"{split_name}_{step}.mp4", keys=vis_keys, num_timestamps=max(n_t, 1),
                  fps=cfg.render.fps, num_cams=self.dataset.num_cams)
            self._write_json(f"metrics_{split_name}_{step}.json", metrics)
            logger.info("[%s] %s", split_name, metrics)
            if self.wandb is not None and frames:
                panel = {}
                stride = max(len(frames) // 3, 1)
                for i, fr in enumerate(frames[::stride][:3]):
                    for k in ("rgb", "gt_rgb", "depth", "dynamic_rgb"):
                        if k in fr:
                            img = np.asarray(fr[k], np.float32)
                            if img.ndim == 2:
                                img = img / max(float(img.max()), 1e-6)
                            panel[f"{split_name}/{k}_{i}"] = self.wandb.Image(np.clip(img, 0, 1))
                self.wandb.log(panel, step=step)

        if cfg.render.render_low_res:
            _run("lowres", self.dataset.full_indices, cfg.render.low_res_downscale)
        if cfg.render.render_test and self.dataset.has_test_split:
            _run("test", self.dataset.test_indices, 1)
        if cfg.render.render_full:
            _run("full", self.dataset.full_indices, 1)

        if cfg.render.render_novel_trajectory:
            frames = render_novel_trajectory(self.renderer, self.dataset,
                                             downscale=cfg.render.low_res_downscale)
            _save(frames, f"novel_{step}.mp4", keys=[k for k in ("rgb", "depth") if k in frames[0]],
                  num_timestamps=len(frames), fps=cfg.render.fps * 2, num_cams=1)
            logger.info("Rendered novel trajectory (%d frames)", len(frames))

        if self.dataset.lidar is not None:
            rmses = []
            for f_idx in range(0, self.dataset.num_frames, max(self.dataset.num_frames // 4, 1)):
                rays = self.dataset.get_lidar_render_rays(f_idx)
                if rays is None or len(rays["origins"]) == 0:
                    continue
                gt_ranges = rays.pop("ranges")
                out = self.renderer.render_rays_chunked(rays, is_lidar=True)
                rmses.append(compute_valid_depth_rmse(out["depth"][..., 0], gt_ranges))
            if rmses:
                results["lidar/depth_rmse"] = float(np.mean(rmses))

        self._write_json(f"metrics_all_{step}.json", results)
        logger.info("Evaluation results: %s", results)
        self._barrier()
        return results
