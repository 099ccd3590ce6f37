"""EmerNeRF training CLI of the PyTorch port (counterpart of the repository's
``train_emernerf.py``).

The same flags and dotlist (``--config_file ... a.b=c``), run tree
(``<output_root>/<project>/<run_name>``), config snapshots and seeding;
``--device`` (default ``cuda``) picks the device.  Run from the repository
root::

    python -m emernerf_torch.train_emernerf --config_file configs/x.yaml \\
        --run_name r data.dataset=synthetic optim.num_iters=50
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import time

import numpy as np

from emernerf_torch.builders import build_dataset_from_cfg
from emernerf_torch.config import load_config
from emernerf_torch.data.waymo import delete_features
from emernerf_torch.eval.data_preview import render_data_video
from emernerf_torch.eval.points import PointQueryEngine
from emernerf_torch.eval.video import have_imageio
from emernerf_torch.eval.voxel_vis import visualize_scene_flow, visualize_voxels
from emernerf_torch.flagship import DEFAULT_CONFIG
from emernerf_torch.train.checkpoints import latest_checkpoint
from emernerf_torch.train.trainer import Trainer
from emernerf_torch.utils.logging import setup_logging

logger = logging.getLogger("emernerf_torch")


def get_args_parser():
    parser = argparse.ArgumentParser("Train EmerNeRF (PyTorch port) for a single scene")
    parser.add_argument("--config_file", help="path to config file", type=str, default=None)
    parser.add_argument("--eval_only", action="store_true", help="perform evaluation only")
    parser.add_argument(
        "--auto_resume", action="store_true",
        help="resume from the newest checkpoint in the run directory if one exists (a "
        "preempted job restarted with the SAME command continues where it stopped; "
        "unlike resume_from, periodic checkpointing stays enabled)")
    parser.add_argument("--visualize_voxel", action="store_true",
                        help="visualize voxel field after training")
    parser.add_argument("--render_data_video", action="store_true",
                        help="render a data inspection video before training")
    parser.add_argument("--render_data_video_only", action="store_true",
                        help="render the data video and exit")
    parser.add_argument("--render_video_postfix", type=str, default=None,
                        help="an optional postfix for rendered video names")
    parser.add_argument("--output_root", default="./work_dirs/", type=str,
                        help="output root directory")
    parser.add_argument("--project", default="emernerf_torch", type=str,
                        help="project name (sub-directory of output root)")
    parser.add_argument("--run_name", default="debug", type=str,
                        help="run name (sub-directory of project)")
    parser.add_argument("--enable_wandb", action="store_true",
                        help="enable wandb logging (no-op if wandb is unavailable)")
    parser.add_argument("--entity", default=None, type=str, required=False,
                        help="wandb entity name")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) or cpu, the plain versions of the kernels")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="dotlist config overrides, e.g. data.scene_idx=700")
    return parser


def setup(args):
    """Merge configs, create the run directory tree, snapshot the config,
    seed the host generators."""
    cfg = load_config(DEFAULT_CONFIG, args.config_file, args.opts)
    log_dir = os.path.join(args.output_root, args.project, args.run_name)
    cfg.log_dir = log_dir
    cfg.project = args.project
    cfg.run_name = args.run_name
    if getattr(args, "entity", None):
        cfg.wandb_entity = args.entity
    os.makedirs(log_dir, exist_ok=True)
    for sub in ("images", "full_videos", "test_videos", "lowres_videos", "metrics",
                "configs_bk", "buffer_maps"):
        os.makedirs(os.path.join(log_dir, sub), exist_ok=True)

    setup_logging(output=log_dir)
    logger.info("Config:\n%s", cfg.to_yaml())
    cfg.save(os.path.join(log_dir, "config.yaml"))
    cfg.save(os.path.join(log_dir, "configs_bk", f"config_{int(time.time())}.yaml"))

    random.seed(cfg.optim.seed)
    np.random.seed(cfg.optim.seed)
    return cfg


def _render_data_video(dataset, cfg) -> None:
    """The data-inspection video ``data.mp4`` (one warning instead without
    ``imageio``)."""
    if not have_imageio():
        logger.warning("imageio is not installed: no data video is written")
        return
    render_data_video(dataset, os.path.join(cfg.log_dir, "data.mp4"), fps=cfg.render.fps)


def _visualize(trainer, cfg) -> None:
    """The occupied voxels (per training timestep with the dynamic branch)
    as ``voxels.npz`` and ``voxels.html``, and with the flow branch the
    lidar scene flow as ``scene_flow.npz``."""
    engine = PointQueryEngine(trainer.model, device=trainer.device)
    times = (list(trainer.dataset.unique_normalized_training_timestamps)
             if trainer.model.has_dynamic else None)
    visualize_voxels(engine, trainer.dataset.aabb, os.path.join(cfg.log_dir, "voxels"),
                     timesteps=times, voxel_size=cfg.render.vis_voxel_size, save_html=True)
    if trainer.model.has_flow:
        visualize_scene_flow(engine, trainer.dataset, os.path.join(cfg.log_dir, "scene_flow"))


def main(argv=None):
    """Train (or with ``--eval_only`` evaluate) one scene; returns the
    ``Trainer`` (None with ``--render_data_video_only``, which builds no
    model)."""
    args = get_args_parser().parse_args(argv)
    cfg = setup(args)

    if args.render_data_video_only:
        _render_data_video(build_dataset_from_cfg(cfg), cfg)
        logger.info("Render data video only, exiting...")
        return None

    if args.auto_resume and not cfg.resume_from:
        ckpt = latest_checkpoint(cfg.log_dir)
        if ckpt is not None:
            cfg.resume_from = ckpt
            # unlike a hand-set resume_from (the reference's quirk: resumed
            # runs never save), an auto-resumed run keeps saving
            cfg.auto_resumed = True
            logger.info("auto_resume: resuming from %s", ckpt)
        else:
            logger.info("auto_resume: no checkpoint yet under %s", cfg.log_dir)

    if (args.eval_only or args.visualize_voxel) and not cfg.resume_from:
        # evaluating a random init by accident helps no one: take the newest
        # checkpoint of the run directory
        ckpt = latest_checkpoint(cfg.log_dir)
        if ckpt is None:
            raise FileNotFoundError(f"--eval_only needs a checkpoint: none found under "
                                    f"{cfg.log_dir} and resume_from is unset")
        logger.info("eval_only: resuming from latest checkpoint %s", ckpt)
        cfg.resume_from = ckpt

    trainer = Trainer(cfg, cfg.log_dir, enable_wandb=args.enable_wandb, device=args.device)
    if args.render_data_video:
        _render_data_video(trainer.dataset, cfg)
    if args.visualize_voxel:
        _visualize(trainer, cfg)
    if args.eval_only:
        trainer.evaluate()
        return trainer

    t0 = time.time()
    trainer.train()
    if trainer.preempted:
        # exit inside the preemption grace window: the checkpoint is saved
        logger.info("Preempted: skipping end-of-training evaluation")
        return trainer
    elapsed = time.time() - t0
    iters = cfg.optim.num_iters - trainer.start_step
    rays_per_iter = cfg.data.ray_batch_size * (2 if trainer.step_cfg.has_lidar else 1)
    logger.info("Training done: %d iters in %.1fs (%.0f rays/s)", iters, elapsed,
                iters * rays_per_iter / max(elapsed, 1e-9))
    trainer.evaluate()
    # reclaim the disk of the scene's feature maps when asked
    if cfg.data.pixel_source.get("delete_features_after_run", False):
        feat_dir = os.path.join(getattr(trainer.dataset, "data_path", ""),
                                cfg.data.pixel_source.feature_model_type)
        if os.path.isdir(feat_dir):
            delete_features(feat_dir)
            logger.info("Deleted the feature maps under %s", feat_dir)
    return trainer


if __name__ == "__main__":
    main()
