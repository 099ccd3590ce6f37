"""The frozen counting functions against hand-worked values at small sizes,
and the frozen reference against the port's plain path at the tiny size."""

import pytest
import torch

from nerfbench.counts import flops, grids, peaks
from nerfbench.reference.plain.ops.brickgrid import BrickGridSpec
from nerfbench.reference.plain.ops.hashgrid import HashGridSpec


def test_grid_ops_by_hand():
    spec = BrickGridSpec(n_input_dims=3, n_levels=2, n_features_per_level=2)
    # per (point, level): 4 D + 2^D (D - 1 + 2F) forward = 12 + 8 * 6
    assert grids.grid_ops(spec, 10, False, False) == 10 * 2 * (12 + 8 * 6)
    # backward: F multiplies per corner; with the position gradient 2F + D^2 more
    assert grids.grid_ops(spec, 10, True, False) == 10 * 2 * (12 + 8 * 4)
    assert grids.grid_ops(spec, 10, True, True) == 10 * 2 * (12 + 8 * 17)
    spec4 = BrickGridSpec(n_input_dims=4, n_levels=1, n_features_per_level=1, time_pair=True)
    assert grids.grid_ops(spec4, 1, False, False) == 16 + 16 * 5
    coarse = BrickGridSpec(n_input_dims=3, n_levels=4, n_features_per_level=1, view_levels=1)
    assert grids.grid_ops(coarse, 1, False, False) == 12 + 8 * 4


@pytest.mark.parametrize("pts,cells", [([[0.3, 0.3, 0.3]], 1), ([[0.3, 0.3, 0.3],
                                                                 [0.3001, 0.3, 0.3]], 1),
                                       ([[0.1, 0.1, 0.1], [0.9, 0.9, 0.9]], 2)])
def test_touched_entries_by_hand(pts, cells):
    """One level of 16 cells a side, linear (no hashing): each distinct cell
    reads its 8 corners' F values; two points in one cell read them once."""
    pos = torch.tensor(pts)
    brick = BrickGridSpec(n_input_dims=3, n_levels=1, base_resolution=16, max_resolution=16,
                          log2_bricks=16, n_features_per_level=2)
    assert grids.brick_touched(brick, pos) == cells * 8 * 2
    hashed = HashGridSpec(n_input_dims=3, n_levels=1, base_resolution=16, max_resolution=16,
                          log2_hashmap_size=19, n_features_per_level=4)
    assert grids.hash_touched(hashed, pos) == cells * 8 * 4


def test_least_seconds_takes_the_larger_bound():
    spec = BrickGridSpec(n_input_dims=3, n_levels=2, n_features_per_level=2)
    n, touched = 1000, 64
    ops = grids.grid_ops(spec, n, False, False)
    n_bytes = n * 3 * 4 + touched * 4 + n * 4 * 2
    want = max(ops / peaks.FP32_FLOPS, n_bytes / peaks.HBM_BYTES_PER_S)
    assert grids.least_seconds(spec, n, touched, False, False, 4, 2) == pytest.approx(want)
    bwd = n * 3 * 4 + n * 4 * 2 + touched * 4 + touched * 4 + n * 3 * 4
    want = max(grids.grid_ops(spec, n, True, True) / peaks.FP32_FLOPS,
               bwd / peaks.HBM_BYTES_PER_S)
    assert grids.least_seconds(spec, n, touched, True, True, 4, 2) == pytest.approx(want)


def test_model_flops_scale_with_the_traffic():
    from nerfbench import harness

    wl = harness.load_workload("flagship-train")
    cfg = harness.load_json("configs", "flagship.json")
    one = flops.train_iteration(cfg, wl)
    two = flops.train_iteration(cfg, dict(wl, overrides={"data.ray_batch_size": 16384}))
    assert two["mlp"] == pytest.approx(2 * one["mlp"]) and two["grid"] == pytest.approx(
        2 * one["grid"])
    # the static base MLP: 40 -> 64 -> 64, 2 in out a sample
    assert flops._mlp_flops([(40, 64), (64, 64)]) == 2 * (40 * 64 + 64 * 64)
    assert one["least_s"] == pytest.approx(one["mlp"] / peaks.BF16_TENSOR_FLOPS
                                           + one["grid"] / peaks.FP32_FLOPS)
    ev = harness.load_workload("flagship-eval")
    frame = flops.eval_frame(cfg, ev)
    half = flops.eval_frame(cfg, dict(ev, overrides=dict(ev["overrides"], **{
        "data.synthetic.image_width": 480})))
    assert half["mlp"] == pytest.approx(frame["mlp"] / 2)


def test_the_reference_is_the_ports_plain_path(monkeypatch):
    """At the tiny size in float32 on the CPU the frozen reference follows
    the program's plain path to rounding: training and eval."""
    from nerfbench import harness
    from nerfbench.reference import compare
    from nerfbench.tests import tiny

    for cell in ("flagship-train", "hash-train"):
        wl, cfg = tiny.tiny_cell(cell)
        ctx = harness.Ctx(cell, wl, cfg, 12345, 0.0, False, torch.device("cpu"), 0.0)
        s = harness.load_module("drivers", "train.py").compared_setup(ctx)
        ref = compare.follow_train(cfg, wl, s["facts"], s["names"], 12345, ctx.device,
                                   s["feeds"])
        nums = compare.train_numbers(s["prog"], ref, wl["grad_diff_quantile"])
        assert s["reasons"] == []
        # the change alone differs: the program keeps a table of 2^20
        # elements or more (the hash cell's full-size flow grid) in bf16
        # Adam moments, the float32 reference in fp32 ones
        assert max(nums["loss"], nums["grad_worst"]) < 1e-6, (cell, nums)
        assert nums["grad_diff_worst"] < 1e-5, (cell, nums)
        assert nums["change"] < 2e-3, (cell, nums)
    wl, cfg = tiny.tiny_cell("flagship-eval")
    ctx = harness.Ctx("flagship-eval", wl, cfg, 12345, 0.0, False, torch.device("cpu"), 0.0)
    samples, names, facts = harness.load_module("drivers", "eval.py").sampled_frames(ctx, 2)
    ref = compare.follow_eval(cfg, wl, facts, names, 12345, ctx.device, samples)
    nums = compare.eval_numbers(samples, ref)
    assert max(nums.values()) < 1e-5, nums
