"""The eval window: whole frames through ``ImageRenderer.render_split(...,
downscale=1)`` with its PSNR and SSIM, as ``Trainer.evaluate`` renders a
split, cycling over the scene's images until ``--seconds`` have passed.

Set-up builds the Trainer of the cell's scene with the seed's weights and
renders ``warmup_frames`` frames.  The rate counts the rays of every frame
rendered (padding not counted) over the seconds from the window's start to
the end of the last frame begun.  From each frame of the window
``sampled_rays_per_frame`` pixels, drawn from the seed, are kept for the
reference.

Workload keys: ``warmup_frames``, ``sampled_rays_per_frame``,
``profiled_frames``, ``limits`` ({rgb, depth, decomposition}).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from nerfbench import harness, hostclock, program, trace, weights
from nerfbench.counts import flops as flop_counts
from nerfbench.reference import compare

MAP_KEYS = ("rgb", "depth") + compare.EVAL_DECOMP


def _sample(maps, img: int, pix: np.ndarray):
    h, w = maps["rgb"].shape[:2]
    kept = {k: np.asarray(maps[k]).reshape(h * w, -1)[pix].astype(np.float32)
            for k in MAP_KEYS if k in maps}
    return {"img": img, "pix": pix, "maps": kept}


class _Cell:
    """The Trainer of the cell's scene with the seed's weights, and its frames."""

    def __init__(self, ctx: harness.Ctx):
        self.trainer, self.facts = program.build_trainer(ctx.config, ctx.workload, ctx.seed,
                                                         ctx.device)
        self.names = [n for n, _ in weights.named_leaves(self.trainer.model,
                                                         self.trainer.prop_models)]
        self.ds = self.trainer.dataset
        self.images = [int(i) for i in self.ds.full_indices]
        self.hw = self.ds.image_hw
        self.rng = np.random.default_rng(int(ctx.seed))
        self.n_sample = int(ctx.workload["sampled_rays_per_frame"])

    def frame(self, k: int):
        """Frame k of the cycle over the scene's images: (image, its maps)."""
        img = self.images[k % len(self.images)]
        frames, _ = self.trainer.renderer.render_split(self.ds, [img], downscale=1)
        return img, frames[0]

    def sample(self, img: int, maps):
        h, w = self.hw
        return _sample(maps, img, self.rng.choice(h * w, self.n_sample, replace=False))

    def close(self, device):
        """The scene's numbers for the reference; the program's state goes."""
        facts = self.facts
        del self.trainer, self.ds
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return facts


def sampled_frames(ctx: harness.Ctx, n: int):
    """(samples, parameter names, scene facts) of the first n frames."""
    cell = _Cell(ctx)
    samples = [cell.sample(*cell.frame(k)) for k in range(n)]
    return samples, cell.names, cell.close(ctx.device)


def run(ctx: harness.Ctx) -> harness.Outcome:
    wl, dev = ctx.workload, ctx.device
    cell = _Cell(ctx)
    h, w = cell.hw
    program.reset_peak(dev)
    for k in range(int(wl["warmup_frames"])):
        cell.frame(k)
    program.sync(dev)

    samples, n_frames = [], 0
    with hostclock.HostClock() as host:
        t0 = host.t0
        deadline = t0 + ctx.seconds
        while True:
            img, maps = cell.frame(n_frames)
            n_frames += 1
            host.tick()
            samples.append(cell.sample(img, maps))
            if time.perf_counter() >= deadline:
                break
        program.sync(dev)
        window_s = time.perf_counter() - t0
    print(f"nerfbench: {host.report()}", file=sys.stderr)
    peak = program.peak_bytes(dev)
    out = harness.Outcome(
        attempted=n_frames, failed=0,
        end_to_end={"eval_rays_per_s": n_frames * h * w / window_s},
        t_window=t0, memory_peak_bytes=peak, checks=[], reasons=[])
    if ctx.trace:
        n_prof = int(wl["profiled_frames"])

        def span():
            for k in range(n_prof):
                cell.frame(n_frames + k)

        with trace.GridRecorder() as grids:
            sp = trace.profile_span(span, dev)
        out.busy_s, out.window_s = sp["busy_s"], sp["wall_s"]
        out.breakdown = trace.breakdown(sp)
        out.trace = dict(kind="eval", span=sp, units=n_prof, grid_calls=grids.calls,
                         unprofiled_s_per_unit=window_s / n_frames,
                         flops=flop_counts.eval_frame(ctx.config, wl),
                         config=ctx.config, workload=wl)
        trace.resolve_grid_calls(out.trace)

    names, facts = cell.names, cell.close(dev)
    ref = compare.follow_eval(ctx.config, wl, facts, names, ctx.seed, dev, samples)
    out.checks = compare.eval_checks(samples, ref, wl["limits"])
    return out
