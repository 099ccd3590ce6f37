"""The training window: ``Trainer.train_iteration`` back to back, as
``Trainer.train`` runs it, from the cell's start step.

Set-up builds one Trainer from the seed, sets its step to the cell's
``start_step``, positions the proposal requires-grad schedule
(``rg_calls_before``) and drives the first ``compared_iterations``
iterations through ``train_iteration`` while it records each step's feed
(batches, draws, flags): those are the steps the reference follows.  Then
``warmup_iterations`` more, and the window: iterations until ``--seconds``
have passed, then one ``torch.cuda.synchronize()``.

Workload keys: ``start_step``, ``rg_calls_before``, ``compared_iterations``,
``warmup_iterations``, ``profiled_iterations``, ``max_step`` (no window
may reach it: the next error-map refresh), ``limits`` ({grad, change,
grad_diff}), ``grad_diff_quantile``.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List

import torch

from nerfbench import harness, hostclock, program, trace, weights
from nerfbench.counts import flops as flop_counts
from nerfbench.reference import compare


class _FeedRecorder:
    """Stands in for the Trainer's TrainStep during the compared
    iterations: records each call's feed, then makes the call."""

    def __init__(self, step_fn, state):
        self._step_fn, self._state = step_fn, state
        self.feeds: List[Dict[str, Any]] = []

    def __getattr__(self, name):
        return getattr(self._step_fn, name)

    def __call__(self, state, pixel_batch, lidar_batch, pixel_draws, lidar_draws, pixel_rg,
                 lidar_rg, lidar_full=False):
        self.feeds.append(dict(step=state.step, pixel=compare.clone_tree(pixel_batch),
                               lidar=compare.clone_tree(lidar_batch),
                               pixel_draws=compare.clone_tree(tuple(pixel_draws)),
                               lidar_draws=compare.clone_tree(
                                   None if lidar_draws is None else tuple(lidar_draws)),
                               pixel_rg=bool(pixel_rg), lidar_rg=bool(lidar_rg),
                               lidar_full=bool(lidar_full)))
        return self._step_fn(state, pixel_batch, lidar_batch, pixel_draws, lidar_draws,
                             pixel_rg, lidar_rg, lidar_full)


class _LidarDrawRecorder:
    def __init__(self, module):
        self.module, self.orig, self.draws = module, module.draw_lidar, []

    def __enter__(self):
        def recorded(scene, n, gen):
            idx = self.orig(scene, n, gen)
            self.draws.append(idx.clone())
            return idx

        self.module.draw_lidar = recorded
        return self

    def __exit__(self, *exc):
        self.module.draw_lidar = self.orig
        return False


def _rays_per_iteration(trainer) -> int:
    return trainer.ray_batch_size * (2 if trainer.step_cfg.has_lidar else 1)


def compared_setup(ctx: harness.Ctx) -> Dict[str, Any]:
    """Builds the Trainer from the seed and drives the compared iterations,
    recording their feeds; returns the trainer, the next step and the
    program's readings of those iterations."""
    from emernerf_torch.train import trainer as trainer_mod

    wl, dev = ctx.workload, ctx.device
    trainer, facts = program.build_trainer(ctx.config, wl, ctx.seed, dev)
    leaves = weights.named_leaves(trainer.model, trainer.prop_models)
    step = int(wl["start_step"])
    trainer.state.step = step
    for _ in range(int(wl["rg_calls_before"])):
        trainer.rg_fn(step)
    rec = _FeedRecorder(trainer.train_step, trainer.state)
    trainer.train_step = rec
    losses, feature_losses, grads, sums = [], [], None, None
    with _LidarDrawRecorder(trainer_mod) as lidar_draws:
        for i in range(int(wl["compared_iterations"])):
            t_it = time.perf_counter()
            # the first iteration's summed gradients wait on the host
            with compare.GradNorms([p for _, p in leaves],
                                   keep="cpu" if i == 0 else None) as rec_grads:
                metrics = trainer.train_iteration(step)
            step += 1
            losses.append(compare.step_loss(metrics))
            if "feature_loss" in metrics:
                feature_losses.append(float(metrics["feature_loss"]))
            if i == 0:
                grads, sums = rec_grads.norms(), rec_grads.sums
            print(f"nerfbench: set-up: compared iteration {i} (step {step - 1}) in "
                  f"{time.perf_counter() - t_it:.2f} s", file=sys.stderr)
    trainer.train_step = rec._step_fn
    p0 = weights.make_weights([(n, tuple(p.shape)) for n, p in leaves], ctx.config["init"],
                              ctx.seed, dev)
    change_norms = compare.change_norms(leaves, p0)
    del p0
    return dict(trainer=trainer, step=step, names=[n for n, _ in leaves], feeds=rec.feeds,
                lidar_draws=lidar_draws.draws,
                prog=dict(losses=losses, grad=grads, grad_sum=sums, change=change_norms,
                          feature_loss=feature_losses),
                reasons=compare.check_feeds(rec.feeds, lidar_draws.draws, facts.tables,
                                            trainer.ray_batch_size),
                facts=facts)


def run(ctx: harness.Ctx) -> harness.Outcome:
    wl, dev = ctx.workload, ctx.device
    s = compared_setup(ctx)
    trainer, step = s.pop("trainer"), s["step"]
    program.reset_peak(dev)
    for _ in range(int(wl["warmup_iterations"])):
        trainer.train_iteration(step)
        step += 1
    program.sync(dev)

    # the window
    max_step = int(wl["max_step"])
    n_it = 0
    with hostclock.HostClock() as host:
        t0 = host.t0
        deadline = t0 + ctx.seconds
        while True:
            trainer.train_iteration(step)
            step += 1
            n_it += 1
            host.tick()
            if time.perf_counter() >= deadline:
                break
            if step >= max_step:
                raise RuntimeError(f"the window reached step {max_step}")
        program.sync(dev)
        window_s = time.perf_counter() - t0
    print(f"nerfbench: {host.report()}", file=sys.stderr)
    rays = n_it * _rays_per_iteration(trainer)
    peak = program.peak_bytes(dev)

    out = harness.Outcome(
        attempted=n_it, failed=0, end_to_end={"train_rays_per_s": rays / window_s},
        t_window=t0, memory_peak_bytes=peak, checks=[], reasons=list(s["reasons"]))
    if ctx.trace:
        n_prof = int(wl["profiled_iterations"])
        start = step

        def span():
            for i in range(n_prof):
                trainer.train_iteration(start + i)

        with trace.GridRecorder() as grids:
            sp = trace.profile_span(span, dev)
        out.busy_s, out.window_s = sp["busy_s"], sp["wall_s"]
        out.breakdown = trace.breakdown(sp)
        out.trace = dict(kind="train", span=sp, units=n_prof, grid_calls=grids.calls,
                         unprofiled_s_per_unit=window_s / n_it,
                         flops=flop_counts.train_iteration(ctx.config, wl),
                         config=ctx.config, workload=wl)
        trace.resolve_grid_calls(out.trace)

    # the program's state goes before the reference runs
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = compare.follow_train(ctx.config, wl, s["facts"], s["names"], ctx.seed, dev,
                               s["feeds"])
    nums = compare.train_numbers(s["prog"], ref, float(wl["grad_diff_quantile"]))
    if s["prog"]["feature_loss"]:
        print(f"nerfbench: feature_loss of the compared iterations: program "
              f"{s['prog']['feature_loss']!r}, reference {ref['feature_loss']!r}",
              file=sys.stderr)
    print("nerfbench: readings (not all compared): "
          + ", ".join(f"{k} {v!r}" for k, v in nums.items()), file=sys.stderr)
    out.checks = compare.train_checks(nums, wl["limits"])
    return out
