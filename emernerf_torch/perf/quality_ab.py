#!/usr/bin/env python
"""Flagship-scale training quality of the port (counterpart of the
repository's ``perf/quality_ab.py``).

Trains the full dynamic+flow flagship on the synthetic driving scene for
``--steps`` iterations per variant and records the smoothed training PSNR /
range RMSE trajectory: every ``record_every`` iterations, the medians of
the last ``eval_window`` iterations' values.  The variants are the
original's table under the original's names, so that a row here and the
JAX record's row of the same name (``perf/QUALITY_r02.json``) ran the same
overrides, with two differences:

- the variants of ``_TIMEPAIR0`` turn the paired 4D rows off through the
  port's ``nerf.model.perf.time_pair=false`` (the original rebuilds the
  grid specs);
- ``REFUSED`` lists the variants the port does not run, with the reason.

The loop is the original's: ``optim.num_iters=steps`` (the whole lr
schedule and the staged lidar-K inside the run), uniform pixel and lidar
batches, proposal gradients at ``it < 512 or it % 5 == 0``.  The batches
and the step's draws come from the port's samplers and a seeded
``torch.Generator`` on the run's device (``--seed``, also the
parameters'; a row of a seed but 0 is named ``<variant>/seed<N>``).
``--with KEY=VALUE ... --name ROW`` adds overrides on top of a variant's
under a row name of its own (an A/B of one setting).  Each row carries the
card's ``nvidia-smi --query-gpu=name,power.limit`` line; rows merge by name into
``--out`` (default ``emernerf_torch/perf/QUALITY_h100.json``, card rows
only), written after every record.  ``quality_report.py`` sets them beside
the JAX record.

Usage (from the repository root, on the card):
    python -m emernerf_torch.perf.quality_ab --variant stagedl16 --steps 2500
    python -m emernerf_torch.perf.quality_ab --variant stagedl16 --steps 2500 \
        --with nerf.sampling.lidar_topk_until=1.0 --name stagedl16_nostage
    python -m emernerf_torch.perf.quality_ab --list
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

# the port's route to unpaired 4D rows (the original rebuilds the grid specs)
TIME_PAIR_OFF = "nerf.model.perf.time_pair=false"

VARIANTS = {
    "base": [],
    "topk0": ["nerf.model.head.temporal_agg_topk=0"],
    "sub4": ["nerf.model.perf.grad_subsample=4"],
    "sub8": ["nerf.model.perf.grad_subsample=8"],
    "nofuse": ["nerf.model.fuse_flow_grid=false"],
    # tcnn-layout hash grids instead of the brick grids
    "hash": ["nerf.model.grid_backend=hash"],
    "timepair0": [TIME_PAIR_OFF],
    "onehot0": ["nerf.model.perf.onehot_budget=0"],
    # top-K sample pruning: K of the 64 final samples, Gumbel temperature 0.3
    "stopk32": ["nerf.sampling.sample_topk=32",
                "nerf.sampling.sample_topk_temp=0.3"],
    "stopk24": ["nerf.sampling.sample_topk=24",
                "nerf.sampling.sample_topk_temp=0.3"],
    "stopk32sub4": ["nerf.sampling.sample_topk=32",
                    "nerf.sampling.sample_topk_temp=0.3",
                    "nerf.model.perf.grad_subsample=4"],
    "stopk32l16": ["nerf.sampling.sample_topk=32",
                   "nerf.sampling.sample_topk_temp=0.3",
                   "nerf.sampling.lidar_sample_topk=16"],
    # halved proposal sample counts, on both branches / the lidar branch
    "prop6432": ["nerf.propnet.num_samples_per_prop=[64,32]"],
    "lprop6432": ["nerf.propnet.lidar_num_samples_per_prop=[64,32]"],
    # every pruning and fusion divergence off, on hash grids
    "refsem": ["nerf.model.grid_backend=hash",
               "nerf.model.head.temporal_agg_topk=0",
               "nerf.sampling.sample_topk=0",
               "nerf.sampling.lidar_sample_topk=0"],
    # staged lidar-K: the lidar branch pruned to 16 samples for the first
    # 90% of the steps, unpruned after (today's defaults)
    "stagedl16": ["nerf.sampling.sample_topk=32",
                  "nerf.sampling.sample_topk_temp=0.3",
                  "nerf.sampling.lidar_sample_topk=16",
                  "nerf.sampling.lidar_topk_until=0.9"],
    # every pruning and fusion divergence off, brick grids kept
    "refsembrick": ["nerf.model.head.temporal_agg_topk=0",
                    "nerf.sampling.sample_topk=0",
                    "nerf.sampling.lidar_sample_topk=0",
                    "nerf.model.fuse_flow_grid=false",
                    TIME_PAIR_OFF],
    # the MX grid (dense coarse bricks + factored fine lines), two ranks
    "mx": ["nerf.model.grid_backend=mx"],
    "mxr32": ["nerf.model.grid_backend=mx", "nerf.model.perf.mx_rank=32"],
    # the matched brick-vs-hash pair at a quarter of the ray batch
    "brick4k": ["data.ray_batch_size=4096"],
    "hash4k": ["data.ray_batch_size=4096",
               "nerf.model.grid_backend=hash"],
    "refsembrick4k": ["data.ray_batch_size=4096",
                      "nerf.model.head.temporal_agg_topk=0",
                      "nerf.sampling.sample_topk=0",
                      "nerf.sampling.lidar_sample_topk=0",
                      "nerf.model.fuse_flow_grid=false",
                      TIME_PAIR_OFF],
    "brick4k2500": ["data.ray_batch_size=4096"],
    "refsem4k2500": ["data.ray_batch_size=4096",
                     "nerf.model.head.temporal_agg_topk=0",
                     "nerf.sampling.sample_topk=0",
                     "nerf.sampling.lidar_sample_topk=0",
                     "nerf.model.fuse_flow_grid=false",
                     TIME_PAIR_OFF],
    # fine-level skipping on the proposal grids
    "finelvl2": ["nerf.propnet.fine_level_skip=2"],
    "finelvl3": ["nerf.propnet.fine_level_skip=3",
                 "nerf.propnet.fine_level_frac=0.375"],
    # the row-knob stacks: both branches' / the pixel branch's
    "rowstack": ["nerf.propnet.lidar_num_samples_per_prop=[64,32]",
                 "nerf.propnet.num_samples_per_prop=[64,32]",
                 "nerf.sampling.sample_topk=24",
                 "nerf.propnet.fine_level_skip=2"],
    "pixstack": ["nerf.propnet.num_samples_per_prop=[64,32]",
                 "nerf.propnet.lidar_num_samples_per_prop=[128,64]",
                 "nerf.sampling.sample_topk=24"],
}

# the variants that turn the 4D time-paired rows off
_TIMEPAIR0 = {"timepair0", "refsembrick", "refsembrick4k", "refsem4k2500"}

# variants the port does not run
REFUSED = {
    "onehot0": "nerf.model.perf.onehot_budget is a TPU lowering knob (ROADMAP.md, "
               "'Leave behind'): the port has one formulation of the brick grid",
}

OUT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "QUALITY_h100.json")


def proposal_rg(it: int) -> bool:
    """Whether iteration ``it`` renders with proposal gradients."""
    return it < 512 or it % 5 == 0


class Curve:
    """The smoothed training curve: every ``record_every`` iterations, the
    medians of the last ``eval_window`` iterations' psnr and range_rmse
    (tensors or arrays; fetched only at a record)."""

    def __init__(self, eval_window: int = 50, record_every: int = 100):
        self.eval_window, self.record_every = eval_window, record_every
        self.points, self._psnrs, self._rmses = [], [], []
        self.t0 = time.time()

    def add(self, it: int, metrics) -> Optional[dict]:
        """Iteration ``it``'s metrics; returns the point it records, if any
        (its ``t``: seconds since the curve began, after the fetch)."""
        self._psnrs.append(metrics["psnr"])
        self._rmses.append(metrics["range_rmse"])
        if (it + 1) % self.record_every:
            return None
        w = [float(p) for p in self._psnrs[-self.eval_window:]]
        r = [float(p) for p in self._rmses[-self.eval_window:]]
        self.points.append({"step": it + 1,
                            "psnr": round(float(np.median(w)), 3),
                            "range_rmse": round(float(np.median(r)), 3),
                            "t": round(time.time() - self.t0, 1)})
        self._psnrs, self._rmses = [], []
        return self.points[-1]


def draw_iteration(scene, step, it: int, ray_batch: int, generator: torch.Generator):
    """Iteration ``it``'s (pixel batch, lidar batch, pixel draws, lidar
    draws, lidar_full) from ``generator`` on the scene's device: uniform
    pixels (no error buffer) and lidar rays, then each branch's draws."""
    from emernerf_torch.data.scene import (
        draw_lidar, draw_pixel, sample_lidar_batch, sample_pixel_batch)
    from emernerf_torch.train.step import draw_step, lidar_full_at

    dev, cfg, flow = scene.images.device, step.cfg, step.model.has_flow
    pixel = sample_pixel_batch(scene, draw_pixel(scene, ray_batch, generator),
                               use_timestamps=True)
    pixel_draws = draw_step(ray_batch, step.render_kw(False), flow, generator, dev)
    full = lidar_full_at(cfg, it)
    lidar = lidar_draws = None
    if cfg.has_lidar:
        lidar = sample_lidar_batch(scene, draw_lidar(scene, ray_batch, generator))
        lidar_draws = draw_step(ray_batch, step.render_kw(True, full), flow, generator, dev)
    return pixel, lidar, pixel_draws, lidar_draws, full


def card_line(device) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card; None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def variant_overrides(name: str):
    """The dotlist of variant ``name``; raises for a refused one."""
    if name in REFUSED:
        raise ValueError(f"variant {name!r} is not run by the port: {REFUSED[name]}")
    return list(VARIANTS[name])


def row_name(name: str, seed: int = 0) -> str:
    """The row of variant ``name`` trained from ``seed``: the variant's own
    name at seed 0 (the JAX record's rows ran one seed), else
    ``<name>/seed<seed>``."""
    return name if seed == 0 else f"{name}/seed{seed}"


def run_variant(name: str, steps: int, eval_window: int = 50, record_every: int = 100,
                device="cuda", tiny: bool = False, out: str = OUT_PATH, seed: int = 0,
                extra=(), row: Optional[str] = None):
    """Train variant ``name`` of the flagship (``tiny``: the CPU-sized one)
    for ``steps`` iterations on ``device`` (the card unless the caller asks
    for the CPU) from ``seed`` (the parameters' and the draws'), recording
    its curve into ``out`` under ``row`` (default :func:`row_name`; a run
    with ``extra`` overrides on top of the variant's must name its row);
    returns the row."""
    from emernerf_torch import resolve_device
    from emernerf_torch.flagship import build_flagship
    from emernerf_torch.train.state import init_train_state
    from emernerf_torch.train.step import build_train_step, lidar_full_at

    overrides = variant_overrides(name) + list(extra)
    if extra and row is None:
        raise ValueError("a run with extra overrides needs a row name of its own")
    dev = resolve_device(device)
    if out == OUT_PATH and dev.type != "cuda":
        raise ValueError(f"{OUT_PATH} holds card rows only: pass another out")
    cfg, dataset, model, prop_models, step_cfg = build_flagship(
        tiny, [f"optim.num_iters={steps}", *overrides], device=dev, seed=seed)
    scene = dataset.scene_tensors(dev)
    state = init_train_state(model, prop_models)
    step = build_train_step(model, prop_models, step_cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    fields = {
        "defaults_lidar_topk_until": float(step_cfg.lidar_topk_until),
        "defaults_era": "staged" if lidar_full_at(step_cfg, steps - 1) else "prestaged",
        "card": card_line(dev),
        "device": str(dev),
        "seed": seed,
        "variant": name,
        "extra": list(extra),
    }
    row = row or row_name(name, seed)

    curve = Curve(eval_window, record_every)
    for it in range(steps):
        pixel, lidar, pd, ld, full = draw_iteration(scene, step, it, cfg.data.ray_batch_size,
                                                    gen)
        rg = proposal_rg(it)
        m = step(state, pixel, lidar, pd, ld, rg, rg, full)
        point = curve.add(it, m)
        if point is not None:
            print(f"[{row}] {it + 1}/{steps}  psnr {point['psnr']:.2f} "
                  f"rmse {point['range_rmse']:.2f}", flush=True)
            # a run cut by its time limit keeps the curve so far
            _write_result(row, steps, time.time() - curve.t0, curve.points, True, fields, out)
    result = _write_result(row, steps, time.time() - curve.t0, curve.points, False, fields, out)
    print(json.dumps({row: {k: v for k, v in result.items() if k != "curve"}}))
    return result


def _write_result(name, steps, wall, curve, partial, fields, out):
    # steady-state step time: the slope of the curve's timestamps after the
    # first record, so that the warm-up is excluded
    steady = None
    if len(curve) >= 2:
        steady = round((curve[-1]["t"] - curve[0]["t"])
                       / (curve[-1]["step"] - curve[0]["step"]) * 1e3, 1)
    result = {
        "steps": steps,
        "steps_done": curve[-1]["step"] if curve else 0,
        "partial": partial,
        "wall_s": round(wall, 1),
        "wall_ms_per_step_incl_compile": round(
            wall / max(curve[-1]["step"], 1) * 1e3, 1) if curve else None,
        "steady_ms_per_step": steady,
        "final_psnr": curve[-1]["psnr"] if curve else None,
        "final_range_rmse": curve[-1]["range_rmse"] if curve else None,
        "curve": curve,
    }
    result.update(fields)
    merged = {}
    if os.path.exists(out):
        with open(out) as f:
            merged = json.load(f)
    merged[name] = result
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(merged, f, indent=1)
    os.replace(tmp, out)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="base")
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="the parameters' and the draws' seed; rows of seeds but 0 are "
                    "named <variant>/seed<N>")
    ap.add_argument("--out", default=OUT_PATH)
    ap.add_argument("--with", dest="extra", nargs="+", default=[], metavar="KEY=VALUE",
                    help="dotlist overrides on top of the variant's (needs --name)")
    ap.add_argument("--name", default=None, help="the row's name (default: the variant's)")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    if args.list:
        print(" ".join(n for n in VARIANTS if n not in REFUSED))
        return
    run_variant(args.variant, args.steps, device=args.device, out=args.out, seed=args.seed,
                extra=args.extra, row=args.name)


if __name__ == "__main__":
    main()
