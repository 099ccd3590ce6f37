"""The system under test, built as its users build it: the port's
``Trainer`` on the cell's configuration, with the benchmark's weights and
draws from the seed.  The program is imported here and in the drivers
only; the reference imports nothing of it."""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Any, Dict

import torch

from nerfbench import scene as scene_mod
from nerfbench import weights


def port_config(config: Dict[str, Any], workload: Dict[str, Any]):
    """The port's ConfigNode of the configuration with the cell's overrides
    (dotted keys) applied."""
    from emernerf_torch.config import ConfigNode

    cfg = ConfigNode(config["cfg"])
    for key, value in workload.get("overrides", {}).items():
        cfg.set_dotted(key, value)
    return cfg


def scene_dataset(scene: Dict[str, Any], cfg):
    """The port's SceneDataset of the benchmark's scene, as a loader builds
    one from the scene it read (the feature maps where the configuration
    loads features)."""
    from emernerf_torch.data.dataset import SceneDataset

    pix = cfg.data.pixel_source
    lidar = scene["lidar"] if cfg.data.lidar_source.load_lidar else None
    return SceneDataset(
        images=scene["images"], c2w=scene["c2w"], intrinsics=scene["intrinsics"],
        frame_idx=scene["frame_idx"], cam_ids=scene["cam_ids"],
        sky_masks=scene["sky_masks"] if pix.load_sky_mask else None,
        dynamic_masks=scene["dynamic_masks"] if pix.load_dynamic_mask else None,
        features=scene["features"] if pix.load_features else None,
        lidar=None if lidar is None else dict(lidar), aabb=scene["aabb"],
        test_image_stride=pix.test_image_stride,
        buffer_downscale=pix.sampler.buffer_downscale, buffer_ratio=pix.sampler.buffer_ratio)


@contextlib.contextmanager
def _dataset_source(scene: Dict[str, Any]):
    """The Trainer builds its dataset from the benchmark's scene."""
    from emernerf_torch.train import trainer as trainer_mod

    orig = trainer_mod.build_dataset_from_cfg
    trainer_mod.build_dataset_from_cfg = lambda cfg, device=None: scene_dataset(scene, cfg)
    try:
        yield
    finally:
        trainer_mod.build_dataset_from_cfg = orig


def build_trainer(config: Dict[str, Any], workload: Dict[str, Any], seed: int, device):
    """(the Trainer of the cell, the facts of its scene): the scene made by
    the benchmark (``nerfbench/scene.py``), no log dir (the Trainer writes
    no files), weights made from ``seed`` and draws from the seed's second
    stream."""
    from emernerf_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    scene = scene_mod.make_scene(config, workload.get("overrides", {}), device)
    t1 = time.perf_counter()
    with _dataset_source(scene):
        trainer = Trainer(port_config(config, workload), log_dir=None, device=device)
    print(f"nerfbench: set-up: scene made in {t1 - t0:.2f} s, the Trainer built (the scene "
          f"uploaded) in {time.perf_counter() - t1:.2f} s", file=sys.stderr)
    leaves = weights.named_leaves(trainer.model, trainer.prop_models)
    n_params = sum(p.numel() for _, p in leaves)
    want = workload.get("n_params", config.get("n_params"))
    if want is not None and n_params != int(want):
        raise RuntimeError(f"the build has {n_params} parameters, the configuration "
                           f"states {want}")
    weights.load_weights(leaves, config["init"], seed)
    trainer.generator.manual_seed(int(seed) + weights.DRAW_STREAM)
    return trainer, scene_mod.facts(scene)


def reset_peak(device) -> None:
    """The peak from here on: the window's, not the set-up's checks'."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
