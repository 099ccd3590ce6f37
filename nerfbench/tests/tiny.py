"""The cells at a size a CPU test run holds: the tiny flagship's grids and
sample counts (``emernerf_torch/flagship.py``'s tiny dotlist), widened so
that top-K pruning, the aggregation and both proposal levels do work, with
a short window, computed in float32 as the repository's parity tests hold
the port (the program's plain path then meets the float32 reference to
rounding, and a fault or the control stands out against the cell's
limits); every other setting of the cell is kept."""

from __future__ import annotations

import copy

from nerfbench import harness

TINY = {
    "data.ray_batch_size": 64,
    "data.synthetic.num_frames": 3,
    "data.synthetic.image_height": 16,
    "data.synthetic.image_width": 24,
    "nerf.model.xyz_encoder.n_levels": 4,
    "nerf.model.xyz_encoder.log2_hashmap_size": 10,
    "nerf.model.xyz_encoder.max_resolution": 64,
    "nerf.model.dynamic_xyz_encoder.n_levels": 4,
    "nerf.model.dynamic_xyz_encoder.log2_hashmap_size": 10,
    "nerf.model.dynamic_xyz_encoder.max_resolution": 64,
    "nerf.propnet.num_samples_per_prop": [32, 16],
    "nerf.propnet.fine_level_skip": 0,
    "nerf.propnet.xyz_encoder.n_levels_per_prop": [2, 2],
    "nerf.propnet.xyz_encoder.max_resolution_per_prop": [32, 64],
    "nerf.propnet.xyz_encoder.lgo2_hashmap_size_per_prop": [10, 10],
    "nerf.sampling.num_samples": 8,
    "nerf.model.neck.geometry_feature_dim": 16,
    "nerf.model.neck.base_mlp_layer_width": 16,
    "nerf.model.head.head_mlp_layer_width": 16,
    "render.render_chunk_size": 128,
    "nerf.model.table_dtype": "float32",
    "nerf.model.mlp_dtype": "float32",
}
# pruning on where the configuration prunes
TINY_TOPK = {"nerf.sampling.sample_topk": 6, "nerf.sampling.lidar_sample_topk": 4,
             "nerf.model.head.temporal_agg_topk": 2}
# a lidar of 8 beams, 48 azimuths
TINY_LIDAR = {"lidar_beams": 8, "lidar_azimuths": 48}
# the eval scene: 2 frames x 3 cameras, still tiny
TINY_EVAL = {"data.synthetic.num_frames": 2, "data.pixel_source.num_cams": 3}
# EmerNeRF's feature lifting on a cell: feature maps of a (3, 5) patch grid
# (a 28 x 42 resize at stride 7) and 16 channels, the DINO, DINO-sky and
# learnable-PE heads with their feature loss
TINY_FEATURES = {"data.pixel_source.load_features": True,
                 "nerf.model.head.enable_feature_head": True,
                 "data.pixel_source.feature_extraction_size": [28, 42],
                 "data.pixel_source.target_feature_dim": 16}


def tiny_cell(cell: str, extra=None):
    """(workload, config) of ``cell`` at the tiny size, with ``extra``
    overrides (dotted keys) on top."""
    wl = copy.deepcopy(harness.load_workload(cell))
    cfg = copy.deepcopy(harness.load_json("configs", f"{wl['config']}.json"))
    over = dict(TINY)
    if int(cfg["cfg"]["nerf"]["sampling"]["sample_topk"]) > 0:
        over.update(TINY_TOPK)
    if wl["kind"] == "eval":
        over.update(TINY_EVAL)
        wl["sampled_rays_per_frame"] = 32
    wl["overrides"] = {**wl.get("overrides", {}), **over, **(extra or {})}
    wl.pop("n_params", None)
    cfg["n_params"] = None
    cfg["scene"] = {**cfg["scene"], **TINY_LIDAR}
    return wl, cfg


def run_tiny(monkeypatch, cell: str, trace: int = 0, seed: int = 2 ** 31 + 7,
             seconds: float = 1.0, device="cpu", extra=None):
    """One run of ``cell`` at the tiny size (``extra``: overrides on top) on
    the CPU, the harness's look for a card skipped: (exit code, the last
    line of stdout as a dict or None, stderr)."""
    import io
    import json
    import time
    import types

    import torch

    wl, cfg = tiny_cell(cell, extra)
    orig_json = harness.load_json
    monkeypatch.setattr(harness, "load_workload", lambda c: wl)
    monkeypatch.setattr(harness, "load_json",
                        lambda *p: cfg if p[0] == "configs" else orig_json(*p))
    out, err = io.StringIO(), io.StringIO()
    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
    rc = harness.run(args, t_start=time.perf_counter(),
                     device=None if device is None else torch.device(device), out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def control_checks(cell: str, extra=None):
    """The checks of ``cell`` at the tiny size (``extra``: overrides on top)
    with the control in the program's place: the reference computed in fp8
    (e4m3 forward, e5m2 backward), against the float32 reference."""
    import torch

    from nerfbench.reference import compare

    wl, cfg = tiny_cell(cell, extra)
    ctx = harness.Ctx(cell, wl, cfg, 2 ** 31 + 11, 0.0, False, torch.device("cpu"), 0.0)
    driver = harness.load_module("drivers", f"{wl['kind']}.py")
    control = (torch.float8_e4m3fn, torch.float8_e5m2)
    if wl["kind"] == "train":
        s = driver.compared_setup(ctx)
        args = (cfg, wl, s["facts"], s["names"], ctx.seed, ctx.device, s["feeds"])
        ref = compare.follow_train(*args)
        low = compare.follow_train(*args, round_dtype=control)
        return compare.train_checks(
            compare.train_numbers(low, ref, wl["grad_diff_quantile"]), wl["limits"])
    samples, names, facts = driver.sampled_frames(ctx, 2)
    args = (cfg, wl, facts, names, ctx.seed, ctx.device, samples)
    ref = compare.follow_eval(*args)
    low = compare.follow_eval(*args, round_dtype=control)
    return compare.eval_checks([dict(s, maps=m) for s, m in zip(samples, low)], ref,
                               wl["limits"])
