#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (emernerf_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero; nothing is skipped):
  1. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit;
  2. build: compiles kernels/csrc/*.cu with nvcc (one process per source)
     into build/emernerf_torch/;
  3. kernels: each kernel against its plain PyTorch version on the card,
     the forward kernels at the flagship eval shapes (one 16,384-ray
     chunk; K1 forward bit for bit in fp32, on the fp32 table with a bf16
     computation (the flagship's route, beside the route it replaced: the
     table cast to bf16, then the bf16 kernel) and on a bf16 table; K2 and
     K3 forward with the wrapper's time and the kernel's alone), the
     training kernels (K1 backward, K8 Adam) at the shapes of one
     8,192-ray pixel branch and over the flagship's parameter list, with
     max abs/rel error, elements over tolerance and median times of both;
     K1 backward also on ray-ordered top-K-like samples (32 per ray; the
     warped fused queries 16 per ray), its position gradients bit for bit
     with the plain version and with a second run; then K3 backward at the
     three calls of a training branch (the proposal levels' (8192, 128, 1)
     and (8192, 64, 1) with the transmittance's cotangent, the pixel
     composite's (8192, 64, 1) with four value channels and every
     cotangent) and K5 forward and backward grouped as training calls them
     (both cache levels, 129 and 65 edges, in one launch; each radius at
     each level), each with the wrapper's time and, after phase 8, the
     kernel's alone;
  4. eval: the full-width flagship (default bf16 config, seeded random
     weights) renders 2 images of 160x240 through ImageRenderer.render_split;
     every map must be finite and every forward kernel's launch counter
     above 0; the K3 forward calls of one more image by (R, S, D, C);
     then a 2,048-ray chunk in fp32 on the card (kernels) against the same
     params on the CPU (plain versions);
  5. train: emernerf_torch.train.trainer.Trainer trains the full-width
     flagship (bf16 default config, seed 0): 3 warm-up and 12 timed
     iterations, then iterations 2000 (an error-map refresh) and 2001 (the
     line-of-sight loss live, buffered pixel sampling).  Every loss must be
     finite, every parameter must change and every kernel's launch counter
     must be above 0; prints ms/iteration, rays/s and peak memory, and the
     launches of K5 and K3 backward over the timed steps (where every
     render after the first takes proposal gradients) and over iterations
     2000-2001 (where one render in six does), failing unless K5 launched
     once forward and once backward per such render;
     It then traces 2 more iterations with torch.profiler (CUDA activity),
     writes the device time by kernel to chiprun_out/profile_train.json and
     prints the share of K1 and K4 forward and backward, of the transposes
     and of copies, casts and fills; then lists, over one more iteration,
     every dtype cast of a tensor the size of a grid table (none may cast
     a brick table), and the K3 forward calls of another by (R, S, D, C);
  5b. one fp32 training step of the tiny flagship on the card (kernels)
     against the CPU (plain versions), same params, batches and draws:
     every loss and every parameter gradient of both branches;
  3 (K4). the hash-grid kernel, forward and backward, against its plain
     versions at the grids and shapes of one 8,192-ray pixel branch of the
     reference-hash flagship (configs/reference_semantics.yaml with
     nerf.model.grid_backend=hash), in bf16 and fp32, at uniform random
     positions, with the features-minor copy the forward reads timed alone
     (features_minor, bit for bit with table.t().contiguous()); then
     forward and backward in bf16 on ray-ordered samples (8,192 rays
     through the unit cube; the dynamic grid's 3N batch and the flow grid's
     warped 2N), with each level's distinct rows per warp;
  6. train: Trainer trains the full-width reference-hash flagship (bf16
     default dtypes, seed 0): 3 warm-up and 8 timed iterations, then
     iterations 2000 and 2001.  Every loss finite, every parameter changed,
     K4's counters above 0 and K1's unmoved; ms/iteration, rays/s, peak
     memory and a torch.profiler table (chiprun_out/profile_train_hash.json)
     with the grid kernels' shares of the device time, as in phase 5;
  6b. eval: 2 images of that model through ImageRenderer: finite maps, K4's
     forward counter above 0, K1's unmoved;
  6c. one fp32 training step of the tiny reference-hash flagship, card vs
     CPU, as in 5b;
  7. the gather/scatter probes P1-P4: both probe entry points
     (emernerf_torch.perf.pallas_experiments, .bench_scatter_alts, every
     case at full size) with the launch counters zeroed before and read
     after; then each probe kernel at every shape they run against its plain
     version (P1, P2 bit for bit; P3, P4 within 1e-5 of the largest |value|)
     with kernel, plain and library times (index_select / index_add_, and
     for P4 the chunked one-hot torch.matmul), rows/s, GB/s and the bound;
     for P4 also the route the wrapper takes (gather_scatter.cu), bound /
     time and the route's kernel-only device time, for P1 the kernel's
     device time alone; P3 also at odd widths (w = 1, 3, 6, 130), on an
     update view at a 4-byte offset and with every index 0, each with the
     vector width p3_plan picks, its kernel's time alone and the share of
     the bound alone and for the call;
  8. the training CLI (emernerf_torch.train_emernerf.main) on the full-width
     brick flagship in a temporary run directory: a few iterations with a
     periodic checkpoint, SIGTERM during an iteration (the preemption
     checkpoint), --auto_resume to the end (a periodic checkpoint again, the
     end-of-training evaluation: lowres and test metric JSONs, lidar depth
     RMSE), the restored state against the saved one bit for bit on the
     card, and --eval_only; prints the CLI's ms/iteration beside phase 5's,
     the checkpoint's size and its save and load seconds;
  9. the dynamic-only profile (configs/default_dynamic.yaml, the flow
     branch off): K1 forward (bit for bit) and backward against the plain
     versions on its dynamic grid (paired 4D rows, F = 4) at the top-K
     queries of one 8,192-ray branch, and the forward at those of one
     16,384-ray eval chunk; Trainer on the full-width model, 3 warm-up and 6 timed
     iterations, then iterations 2000 and 2001, checked as phase 5 (every
     loss finite, every parameter changed, K1's counters above 0, K4's
     unmoved, no grid table cast) and without flow (no cycle loss); 9b, 2
     images through ImageRenderer, finite maps and no flow maps; 9c, one
     fp32 tiny training step, card vs CPU, as in 5b;
  10. the reference-semantics profile on brick grids (configs/
     reference_semantics.yaml: separate dynamic and flow grids of unpaired
     4D rows, every sample shaded and flow-warped): K1 forward (bit for
     bit) and backward (position gradients bit for bit) against the plain
     versions on those grids at one 8,192-ray branch's ray-ordered
     queries, and the forward at one eval chunk's; then as phase 9 with
     flow (10, 10b, 10c);
  11. K3 forward against its plain version at every (R, S, D, C) that the
     training runs (densities that require a gradient) and the eval renders
     (no_grad) of phases 4-10 launched, called as each calls it, with the
     wrapper's time and the kernel's alone;
  12. the point-query path: configs/default_flow.yaml through the CLI on
     the full-width flagship in a temporary run directory (a few
     iterations, then the evaluation with the lidar scene-flow metrics:
     metrics_flow_{step}.json's five NSFP metrics must be finite; the flow
     eval's seconds and points/s), then --eval_only --visualize_voxel in one
     run with render.eval_sample_topk=32 and the novel trajectory (top-K
     eval rays/s beside the exact render's; the .npz, .html and scene-flow
     export; a cut: render.vis_voxel_size=1.0, 109,200 cells per timestep
     instead of the default 0.3 m's 4.05 M), then --render_data_video_only;
     the videos must exist where imageio is installed, and without it the
     composed first frames (eval/video.py:compose_frame) are checked in
     memory; then the full-width reference-hash flagship's flow evaluation
     and voxel queries (K4).  The launch counters are zeroed before its
     first run and read after its last: every forward kernel must launch;
  12b. K1 forward (the flagship's static and fused grids; fp32 and the
     bf16 computation, bit for bit) at one 65,536-point chunk of the voxel
     grid, at that chunk at a training timestamp, at the warped 2N batch of
     query_attributes and at the flow eval's lidar returns; K4 forward on
     the reference-hash grids at the same chunk; K3 forward at the top-K
     eval's final composite, on inputs zero but at the 32 shaded samples.
  13. the feature head: a Waymo-layout scene written to a temporary
     directory (20 frames of 3 cameras, JPEGs at the cameras' original
     sizes loaded at 640x960, sky and dynamic masks, 160,000 top-lidar
     returns per frame, fp16 (91, 137, 768) feature maps, Occ3D at 0.4 m;
     the cuts are printed), the full-width flagship with the feature head
     through the CLI: a few iterations with the feature loss, the
     evaluation (lowres split with feat_psnr, occupancy eval, the feature
     video or its composed frame), the feature maps deleted; then timed
     iterations, device busy, peak memory and the top device items beside
     phase 5's, then the same scene without the feature head (a control).
     The launch counters are zeroed before its CLI run and read after its
     profiled iterations;
  13b. K3 forward at the training (8192, 64, 1, 68) and eval (16384, 64,
     3, 215) shapes of phase 13 and K3 backward at (8192, 64, 1, 68)
     (emernerf_torch/perf/bench_wide_composite.py times the eval chunk's
     one call beside four calls by channel group).
  14. the nuScenes loader: a devkit-layout scene written to a temporary
     directory (write_nuscenes_scene: the six cameras on 12 Hz chains of
     40-42 JPEGs of 1600x900 with shutters offset and an ego pose per
     image, sky masks, a 20 Hz LIDAR_TOP chain of 34,700-return .pcd.bin
     sweeps; the cuts are printed), the full-width flagship through the
     CLI with data.dataset=nuscenes and six cameras: a few iterations and
     the evaluation; the metas cached by the first load, a second load
     (half the scene) from them with the tables gone, the lidar returns of
     both by the scene_fraction rule; then timed iterations, device busy,
     idle share and peak memory beside phase 5's.  The launch counters are
     zeroed before its CLI run and read after its profiled iterations;
  15a. optim.remat on the full-width flagship: each branch from one state
     and the same draws with remat off and on (losses bit for bit,
     gradients within one bf16 ulp plus 1e-6 of the largest), one whole
     iteration each way (pixel losses bit for bit), then timed iterations
     each way: ms/iteration, busy, peak memory and K1 forward's launches
     per iteration;
  15b. the eval-time temporal interpolation: 2 images of the full-width
     flagship and of the reference-hash flagship with it on (the launches
     of the "interp" and "interp_hash" rows), a chunk and a query_flow
     batch at an off-grid time in fp32, card vs CPU, and at a training
     timestep bit for bit with the exact queries; K1 and K4 forward at the
     flow encodes the interpolation adds to one eval chunk against their
     plain versions;
  15c. spherical-harmonics directions: a 2,048-ray fp32 chunk of the
     full-width flagship, card vs CPU, one fp32 training step of the tiny
     flagship, card vs CPU, and 2 full-width iterations through Trainer.
Every kernel's entry in the {"kernels": ...} line carries its bound: the
larger of the bytes the call must move (inputs read once, outputs written
once; for a grid, the table entries these points touch) over the HBM rate
and its operations over the fp32 rate (H100 SXM data sheet).  Its launches
are those of the training run of its path (phase 5, phase 6 for K4, phase
7's probe run for P1-P4, phase 9 or 10 for the rows of those profiles'
grids and K3 shapes, phase 12's runs for the "points" rows of 12b, phase
13's for the "waymo" rows of 13b, phase 15b's interpolated renders for
the "interp" and "interp_hash" rows; a K3 forward call past 64 channels
counts its two kernels).
The kernels' device times alone (torch.profiler, each kernel's mean over
its records: K2, K3 forward and backward, K5, P1, P3; for K3 past 64
channels, CUDA events around calls queued behind a sleep kernel are
printed beside) are taken last, so that no profiler session precedes a
timed phase; a time under its bound is not reported.
The last two lines are the card line and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_RAYS = 16384  # render.render_chunk_size
N_TRAIN = 8192  # data.ray_batch_size: rays per branch and iteration
PROP_SAMPLES, NUM_SAMPLES = (128, 64), 64
SAMPLE_TOPK, AGG_TOPK = 32, 16  # nerf.sampling.sample_topk, head.temporal_agg_topk
# the eval key set of one chunk: 3 density sets, 23 value channels laid out
# as render/volrend.py:composite_rays packs them
EVAL_SETS = [0] * 4 + [1] * 9 + [0] + [2] * 9
TABLE_SCALE = 2000.0  # fp32 card-vs-CPU checks: tables U(+-0.2), not U(+-1e-4)
# tiny flagship widened so that top-K pruning and both proposal levels
# carry gradients (as tests/test_torch_train_step.py widens it)
TINY_FP32 = ("nerf.model.table_dtype=float32", "nerf.model.mlp_dtype=float32",
             "nerf.propnet.num_samples_per_prop=[32,16]", "nerf.sampling.num_samples=8",
             "nerf.sampling.sample_topk=6", "nerf.sampling.lidar_sample_topk=4")
# the same for the reference-hash profile, which shades every sample
HASH_TINY_FP32 = TINY_FP32[:4]
# NVIDIA H100 SXM (data sheet, at the 700 W limit): HBM rate and the fp32
# rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# kernels by name in a profiler table (the grid kernels of
# kernels/csrc/brickgrid.cu and hashgrid.cu, Adam, the GEMMs, copies):
# the share of each in phases 5 and 6
PROFILE_SHARES = (("K1 backward", ("brickgrid_backward_kernel",)),
                  ("K1 backward's bf16 rounding pass", ("round_to_bf16_kernel",)),
                  ("K1 forward", ("brickgrid_encode_kernel",)),
                  ("K4 forward", ("hashgrid_encode_kernel",)),
                  ("K4 backward", ("hashgrid_backward_kernel",)),
                  ("transposes (features_minor, transpose_cast)",
                   ("features_minor_kernel", "transpose_cast_kernel")),
                  ("Adam (K8)", ("adam_kernel",)),
                  ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
                  # PyTorch's copy (and dtype cast) and fill kernels, memcpy, memset
                  ("copies, casts and fills", ("copy_kernel", "FillFunctor", "Memcpy", "Memset")))
# P4's kernels (kernels/csrc/gather_scatter.cu), both routes
P4_KERNELS = ("scatter_shared_table_kernel", "scatter_red_kernel")


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, iters: int) -> float:
    """Median device time of fn() in ms (CUDA events, after 2 warm-ups)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(fn, iters: int) -> float:
    """Device time per call of fn(), the host ahead of the card: iters calls
    queued between two CUDA events behind a sleep kernel that holds the
    card while the host issues them, so no host time falls between the
    events (the kernels alone where fn launches nothing else)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms: longer than issuing the calls
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def compare(name, out, ref, rtol, atol):
    """(max abs err, max rel err, elements over atol + rtol*|ref|)."""
    out, ref = out.double(), ref.double()
    err = (out - ref).abs()
    over = int((~(err <= atol + rtol * ref.abs())).sum())  # NaN counts as over
    rel = float((err / ref.abs().clamp_min(1e-12)).max()) if err.numel() else 0.0
    mx = float(err.max()) if err.numel() else 0.0
    print(f"  {name}: max_abs_err={mx:.3e} max_rel_err={rel:.3e} over_tol={over} "
          f"(rtol={rtol}, atol={atol}, n={out.numel()})")
    return mx, over


def check(tag, out, ref, rtol, atol_rel):
    """Fails where |err| > atol_rel * max|ref| + rtol * |ref|; max abs err."""
    atol = atol_rel * float(ref.abs().max())
    mx, over = compare(tag, out.float(), ref.float(), rtol, atol)
    if over:
        fail(f"{tag}: {over} elements over tolerance")
    return mx


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the fp32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def add_entry(entries, name, source, replaces, fn, mx, ms, plain_ms, n_bytes, n_ops,
              library_ms=None, path="brick"):
    """One kernel line: its times, its bound, and the training run (path)
    whose launches it reports."""
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {n_bytes / 1e6:.2f} MB, {n_ops / 1e9:.3f} Gop)"
          + ("" if library_ms is None else f", library {library_ms:.3f} ms"))
    entries.append(dict(name=name, route="cuda", source=f"emernerf_torch/kernels/csrc/{source}",
                        replaces=replaces, fn=fn, path=path, max_abs_err=mx, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=library_ms))


def brick_touched(spec, pos) -> int:
    """Table elements that the points read: the distinct (row, corner)
    slots of the 8 live corners (both time slices) per level, times F."""
    from emernerf_torch.ops.brickgrid import _U32, _brick_rows, _cell, level_constants

    scales, strides, uses_hash = level_constants(spec)
    x = pos.reshape(-1, spec.n_input_dims)
    cpa, f = spec.CPA, spec.n_features_per_level
    per_row = spec.row_width // f
    n = 0
    for lvl in range(spec.n_levels):
        sc = float(scales[lvl])
        cells = [_cell(x[:, i], sc)[0] for i in range(spec.n_input_dims)]
        offs = [c & (spec.brick_cells - 1) for c in cells[:3]]
        bricks = [(c >> spec.log2_brick_size) & _U32 for c in cells[:3]]
        t_cell = cells[3] & _U32 if spec.has_time else None
        row = _brick_rows(spec, bricks, t_cell, lvl, strides, uses_hash)
        starts = [row * per_row]
        if spec.uses_time_pair:
            starts.append(row * per_row + spec.corners_per_brick)
        elif spec.has_time:
            starts.append(_brick_rows(spec, bricks, (t_cell + 1) & _U32, lvl, strides,
                                      uses_hash) * per_row)
        corner0 = offs[0] + cpa * (offs[1] + cpa * offs[2])
        slots = [s0 + corner0 + dx + cpa * (dy + cpa * dz)
                 for s0 in starts for dz in range(2) for dy in range(2) for dx in range(2)]
        n += int(torch.unique(torch.cat(slots)).numel())
    return n * f


def hash_touched(spec, pos) -> int:
    """Table elements that the points read: the distinct corner rows per
    level, times F."""
    from emernerf_torch.ops.hashgrid import _level_geometry, level_constants

    consts = level_constants(spec)
    x = pos.reshape(-1, spec.n_input_dims)
    n = sum(int(torch.unique(torch.cat(_level_geometry(x, spec, lvl, consts)[0])).numel())
            for lvl in range(spec.n_levels))
    return n * spec.n_features_per_level


def warp_rows(spec, pos):
    """Per level, the mean over warps (32 consecutive points) and corners
    of (distinct rows, runs of equal rows in neighbouring lanes) among the
    32 lanes: K4 backward issues one atomic per run."""
    from emernerf_torch.ops.hashgrid import _level_geometry, level_constants

    consts = level_constants(spec)
    x = pos.reshape(-1, spec.n_input_dims)
    x = x[:x.shape[0] // 32 * 32]
    out = []
    for lvl in range(spec.n_levels):
        rows = torch.stack(_level_geometry(x, spec, lvl, consts)[0]).reshape(-1, 32)
        runs = 1 + (rows[:, 1:] != rows[:, :-1]).sum(1)
        srt = torch.sort(rows, 1)[0]
        distinct = 1 + (srt[:, 1:] != srt[:, :-1]).sum(1)
        out.append((float(distinct.float().mean()), float(runs.float().mean())))
    return out


def ray_batches(dev, g, n_rays, n_samples):
    """Positions of n_rays x n_samples samples along straight rays through
    the unit cube, ray-major, as the fields stack them: 3D (N, 3); and the
    4D (3N, 4) dynamic batch [current; +warp; -warp] (each ray at its own
    time, warped by a per-ray displacement and one frame of 8 in time),
    whose last two thirds are the flow grid's 2N batch."""
    start = torch.rand((n_rays, 1, 3), device=dev, generator=g)
    end = torch.rand((n_rays, 1, 3), device=dev, generator=g)
    start[..., 0], end[..., 0] = 0.0, 1.0
    s = torch.linspace(0.0, 1.0, n_samples, device=dev)[None, :, None]
    xyz = start + s * (end - start)
    t = torch.rand((n_rays, 1, 1), device=dev, generator=g).expand(-1, n_samples, 1)
    shift = (torch.rand((n_rays, 1, 3), device=dev, generator=g) - 0.5) * 0.04
    cur = torch.cat([xyz, t], -1)
    fwd = torch.cat([(xyz + shift).clamp(0, 1), (t + 1 / 8).clamp(0, 1)], -1)
    bwd = torch.cat([(xyz - shift).clamp(0, 1), (t - 1 / 8).clamp(0, 1)], -1)
    return (xyz.reshape(-1, 3).contiguous(),
            torch.cat([cur, fwd, bwd]).reshape(-1, 4).contiguous())


def grid_ops(spec, n: int, backward: bool, pos_grad: bool) -> float:
    """The least operation count of one grid encode call.  Per (point,
    level): the cell math (4 per dimension), then per corner of the 2^D
    (a 4D brick cell: 8 spatial corners x 2 time slices) the weight, D - 1
    multiplies, and F multiply-adds (forward) or F multiplies w*g (the
    backward's table gradient); the position gradient adds per corner the F
    multiply-adds of gdotf and, per dimension, D - 2 multiplies of the
    partial product, one by gdotf and one add."""
    d, f, lv = spec.n_input_dims, spec.n_features_per_level, spec.n_levels
    per_corner = (d - 1) + (f if backward else 2 * f)
    if backward and pos_grad:
        per_corner += 2 * f + d * d
    return float(n) * lv * (4 * d + (1 << d) * per_corner)


def flagship_specs():
    """The four grid specs of the full-width flagship."""
    import dataclasses

    from emernerf_torch.builders import _enc_spec, flow_spec, make_grid_spec
    from emernerf_torch.flagship import flagship_config

    cfg = flagship_config()
    m, enc = cfg.nerf.model, cfg.nerf.propnet.xyz_encoder
    dyn, flw = _enc_spec(m.dynamic_xyz_encoder, "brick"), flow_spec("brick")
    props = [make_grid_spec("brick", 3, enc.n_levels_per_prop[i],
                            enc.base_resolutions_per_prop[i], enc.max_resolution_per_prop[i],
                            enc.lgo2_hashmap_size_per_prop[i], 1)
             for i in range(2)]
    return {"prop0": props[0], "prop1": props[1], "static": _enc_spec(m.xyz_encoder, "brick"),
            "dynflow": dataclasses.replace(dyn, n_features_per_level=dyn.n_features_per_level
                                           + flw.n_features_per_level)}


def hash_specs():
    """The five grid specs of the full-width reference-hash flagship."""
    from emernerf_torch.builders import _enc_spec, flow_spec, make_grid_spec
    from emernerf_torch.flagship import REFERENCE_HASH, flagship_config

    cfg = flagship_config(profile=REFERENCE_HASH)
    m, enc = cfg.nerf.model, cfg.nerf.propnet.xyz_encoder
    specs = {f"prop{i}": make_grid_spec("hash", 3, enc.n_levels_per_prop[i],
                                        enc.base_resolutions_per_prop[i],
                                        enc.max_resolution_per_prop[i],
                                        enc.lgo2_hashmap_size_per_prop[i], 1)
             for i in range(2)}
    specs.update(static=_enc_spec(m.xyz_encoder, "hash"),
                 dynamic=_enc_spec(m.dynamic_xyz_encoder, "hash"), flow=flow_spec("hash"))
    return specs


def profile_specs(profile):
    """The 4D grid specs of the full-width flagship of ``profile`` with
    separate grids: its dynamic grid and, with a flow branch, its flow
    grid, each with the profile's row pairing (the default profile's fused
    grid is flagship_specs' "dynflow")."""
    from emernerf_torch.builders import _enc_spec, cfg_time_pair, flow_spec
    from emernerf_torch.flagship import flagship_config

    cfg = flagship_config(profile=profile)
    pair = cfg_time_pair(cfg)
    specs = {"dynamic": _enc_spec(cfg.nerf.model.dynamic_xyz_encoder, "brick", pair)}
    if cfg.nerf.model.head.enable_flow_branch:
        specs["flow"] = flow_spec("brick", pair)
    return specs


def profile_grid_cases(specs, xyzt, n):
    """(grid, queries, position gradient) of the grids ``specs`` over the
    ray-ordered 4D batch ``xyzt`` (ray_batches) of n samples: without a
    flow grid, the dynamic grid at the current n; with one, the dynamic
    grid's 3n batch (current, +warp, -warp; the warped queries' positions
    carry a gradient, so the whole batch takes the position gradient) and
    the flow grid's current n and warped 2n."""
    if "flow" not in specs:
        return [("dynamic", xyzt[:n].contiguous(), False)]
    return [("dynamic", xyzt, True), ("flow", xyzt[:n].contiguous(), False),
            ("flow", xyzt[n:].contiguous(), True)]


def phase_profile_kernels(dev, entries, profile, path, label):
    """K1 forward and backward on the separate 4D grids of ``profile``
    (profile_specs; the static and proposal grids are phase 3's) against
    the plain versions, the fp32 parameter with a bf16 computation as the
    fields call it: forward (bit for bit) and backward (k1_backward_row) at
    the ray-ordered queries of one 8,192-ray pixel branch (the samples it
    shades: the top-K, or all 64), then the forward at those of one
    16,384-ray eval chunk (all samples).  The kernel lines report the
    launches of the training run ``path``."""
    from emernerf_torch.builders import cfg_time_pair
    from emernerf_torch.flagship import flagship_config
    from emernerf_torch.ops.brickgrid import brickgrid_encode, brickgrid_encode_ref

    g = torch.Generator(device=dev).manual_seed(9)
    cfg = flagship_config(profile=profile)
    specs, pair = profile_specs(profile), cfg_time_pair(cfg)
    rows = "paired" if pair else "unpaired"
    n_samples = cfg.nerf.sampling.num_samples
    k = cfg.nerf.sampling.sample_topk or n_samples
    print(f"{label} (K1, {rows} rows): K1 forward and backward vs plain versions on the "
          f"{'/'.join(specs)} grid(s) of profile {_profile_name(profile)} at the queries of "
          f"one {N_TRAIN}-ray branch, {k} samples per ray, and K1 forward at those of one "
          f"{N_RAYS}-ray eval chunk, {n_samples} samples per ray")
    for n_rays, per_ray, train in ((N_TRAIN, k, True), (N_RAYS, n_samples, False)):
        _, xyzt = ray_batches(dev, g, n_rays, per_ray)
        cases = profile_grid_cases(specs, xyzt, n_rays * per_ray)
        del xyzt
        for name, pos, pos_grad in cases:
            spec = specs[name]
            if spec.uses_time_pair != pair:
                fail(f"the {name} grid of {_profile_name(profile)}: time_pair "
                     f"{spec.uses_time_pair}, the config asks for {pair}")
            table = torch.rand(spec.table_shape, device=dev, generator=g) * 2 - 1
            with torch.no_grad():
                out = brickgrid_encode(table, pos, spec, torch.bfloat16)
                ref = brickgrid_encode_ref(table, pos, spec, torch.bfloat16)
            tag = (f"brickgrid_encode[{name},{rows}{',warped' if pos_grad else ''},rays"
                   f"{'' if train else ',eval'},fp32->bf16,N={pos.shape[0]}]")
            exact = torch.equal(out, ref)
            print(f"  {tag}: bit for bit with the plain version: {exact} (tolerance 0)")
            if not exact:
                fail(f"{tag}: kernel and plain version differ")
            ms = cuda_ms(lambda: brickgrid_encode(table, pos, spec, torch.bfloat16), 5)
            plain_ms = cuda_ms(lambda: brickgrid_encode_ref(table, pos, spec, torch.bfloat16), 2)
            add_entry(entries, tag, "brickgrid.cu", "emernerf_tpu/ops/brickgrid.py:581",
                      brickgrid_encode, 0.0, ms, plain_ms,
                      nbytes(pos, out) + brick_touched(spec, pos) * table.element_size(),
                      grid_ops(spec, pos.shape[0], False, False), path=path)
            del out, ref
            if train:
                k1_backward_row(entries, f"{name},{rows}", spec, table, pos, pos_grad, g,
                                rays=True, compute=torch.bfloat16, path=path)
            del table, pos
        del cases
        torch.cuda.empty_cache()


def phase_kernels(dev, kernels_entries, after_timed):
    from emernerf_torch.ops.brickgrid import brickgrid_encode, brickgrid_encode_ref
    from emernerf_torch.ops.stepfuns import importance_sampling, importance_sampling_ref
    from emernerf_torch.render.volrend import composite_along_rays, composite_along_rays_ref

    specs = flagship_specs()
    # (name, spec, points per eval chunk)
    cases = [
        ("prop0", specs["prop0"], N_RAYS * PROP_SAMPLES[0]),
        ("prop1", specs["prop1"], N_RAYS * PROP_SAMPLES[1]),
        ("static", specs["static"], N_RAYS * NUM_SAMPLES),
        ("dynflow", specs["dynflow"], N_RAYS * NUM_SAMPLES),
    ]
    g = torch.Generator(device=dev).manual_seed(0)
    print("phase 3: kernels vs plain versions at the flagship eval shapes")
    with torch.no_grad():
        for name, spec, n in cases:
            pos = torch.rand((n, spec.n_input_dims), device=dev, generator=g)
            table32 = torch.rand(spec.table_shape, device=dev, generator=g) * 2 - 1
            table16 = table32.bfloat16()
            touched = brick_touched(spec, pos)
            # (label, stored table, compute dtype): fp32; the flagship's route,
            # the fp32 parameter with a bf16 computation; a bf16 table.  Each
            # bit for bit with the plain version (the same explicitly rounded
            # fp32 operations in the same order, one rounding to the compute
            # dtype)
            for label, table, compute in (("fp32", table32, torch.float32),
                                          ("fp32->bf16", table32, torch.bfloat16),
                                          ("bf16", table16, torch.bfloat16)):
                out = brickgrid_encode(table, pos, spec, compute)
                ref = brickgrid_encode_ref(table, pos, spec, compute)
                tag = f"brickgrid_encode[{name},{label},N={n}]"
                exact = torch.equal(out, ref)
                mx = float((out.float() - ref.float()).abs().max())
                print(f"  {tag}: bit for bit with the plain version: {exact} (tolerance 0)")
                if not exact:
                    fail(f"{tag}: kernel and plain version differ (max abs err {mx:.3e})")
                ms = cuda_ms(lambda: brickgrid_encode(table, pos, spec, compute), 10)
                plain_ms = cuda_ms(lambda: brickgrid_encode_ref(table, pos, spec, compute), 3)
                # the touched entries in the table's storage dtype
                n_bytes = nbytes(pos, out) + touched * table.element_size()
                add_entry(kernels_entries, tag, "brickgrid.cu",
                          "emernerf_tpu/ops/brickgrid.py:581", brickgrid_encode, mx, ms,
                          plain_ms, n_bytes, grid_ops(spec, n, False, False))
                if label == "fp32->bf16":  # the route it replaced, in the same run
                    cast_ms = cuda_ms(lambda: brickgrid_encode(table.bfloat16(), pos, spec), 10)
                    kernels_entries[-1]["cast_route_ms"] = cast_ms
                    print(f"  {tag}: the route it replaced, the table cast to bf16 "
                          f"({table.numel()} elements) then the bf16 kernel: {cast_ms:.3f} ms")
                del out, ref
            del table32, table16, table, pos

        # K2: the three sampling steps of one chunk, plus a jittered one
        for k1, n, jittered in ((2, 128, False), (129, 64, False), (65, 64, False),
                                (65, 64, True)):
            s = torch.sort(torch.rand((N_RAYS, k1), device=dev, generator=g), -1)[0]
            pdf = torch.rand((N_RAYS, k1), device=dev, generator=g) ** 4
            pdf[:, 0] = 0.0
            cdf = torch.cumsum(pdf, -1)
            cdf = cdf / cdf[:, -1:] * 0.97
            cdf[:64] = 0.0  # zero-opacity rays
            cdf[64:128] = 0.5  # flat CDFs
            jitter = ((torch.rand((N_RAYS, 1), device=dev, generator=g) - 0.5) / (n + 1)
                      if jittered else None)
            out = importance_sampling(s, cdf, n, jitter)
            ref = importance_sampling_ref(s, cdf, n, jitter)
            tag = f"importance_sampling[{k1}->{n + 1}{',jitter' if jittered else ''}]"
            mx, over = compare(tag, out, ref, 0.0, 1e-6)
            if over:
                fail(f"{tag}: {over} elements over tolerance")
            ms = cuda_ms(lambda: importance_sampling(s, cdf, n, jitter), 20)
            plain_ms = cuda_ms(lambda: importance_sampling_ref(s, cdf, n, jitter), 10)
            # a binary search over K+1 edges and an interpolation per output edge
            n_ops = N_RAYS * (n + 1) * (2 * math.ceil(math.log2(k1)) + 8)
            add_entry(kernels_entries, tag, "importance_sampling.cu",
                      "emernerf_tpu/ops/stepfuns.py:115", importance_sampling, mx, ms, plain_ms,
                      nbytes(s, cdf, jitter, out), n_ops)
            # the kernel's device time alone, without the wrapper's host time:
            # a profiler session, run after the timed phases (see kernel_only)
            after_timed.append((kernels_entries[-1], ("importance_sampling_kernel",),
                                lambda s=s, cdf=cdf, n=n, jitter=jitter:
                                importance_sampling(s, cdf, n, jitter)))

        # K3: the full eval key set
        composite_row(dev, 7, kernels_entries, after_timed, N_RAYS, NUM_SAMPLES, 3, EVAL_SETS,
                      100.0, grad=False)


def composite_inputs(dev, seed, r, s_, d, n_ch, t_far, grad, keep=0):
    """Seeded K3 inputs: sorted edges in [0.1, t_far), densities U^3 / 2
    (set 0 the sum of sets 1 and 2 where D = 3), values U(0, 1).  With
    ``keep``, as a pruned render scatters its outputs back: densities and
    values zero but at ``keep`` random samples per ray."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.sort(torch.rand((r, s_ + 1), device=dev, generator=g) * t_far, -1)[0] + 0.1
    dens = torch.rand((r, s_, d), device=dev, generator=g) ** 3 * 0.5
    if d == 3:
        dens[:, :, 0] = dens[:, :, 1] + dens[:, :, 2]
    vals = torch.rand((r, s_, n_ch), device=dev, generator=g) if n_ch else None
    if keep:
        kept = torch.rand((r, s_), device=dev, generator=g).argsort(-1)[:, :keep]
        mask = torch.zeros((r, s_, 1), device=dev).scatter_(1, kept[..., None], 1.0)
        dens = dens * mask
        vals = None if vals is None else vals * mask
    return t[:, :-1].contiguous(), t[:, 1:].contiguous(), dens.requires_grad_(grad), vals


# the device kernels of K3 forward's two routes and of its sums above 64
# channels (composite.cu)
K3_FORWARD_KERNELS = ("composite_kernel", "composite_warp_kernel", "composite_sums_kernel")


def remade(make, call):
    """A call for ``after_timed``: call(*make()), its inputs made on its
    first use (after the timed phases) rather than held through them."""
    held = []

    def run():
        if not held:
            held.append(make())
        return call(*held[0])

    return run


def composite_row(dev, seed, kernels_entries, after_timed, r, s_, d, sets, t_far, path="brick",
                  grad=True, keep=0):
    """K3 forward at (r, s_, d, len(sets)) against its plain version, with
    the wrapper's time (as the run calls it: eval under no_grad, training
    with densities that require a gradient, ``grad``) and, after the timed phases,
    the kernel's alone (on the same inputs made again then, so that they
    do not stay allocated through the phases in between); ``keep``: the
    inputs of a render that shaded ``keep`` samples per ray (composite_inputs).
    Tolerance: rtol 1e-5 (depth 1e-4), atol 1e-5; a median depth may move
    one sample only at a 0.5 crossing."""
    from emernerf_torch.render.volrend import composite_along_rays, composite_along_rays_ref

    args = (dev, seed, r, s_, d, len(sets), t_far, grad, keep)
    ts, te, dens, vals = composite_inputs(*args)
    out = composite_along_rays(ts, te, dens, vals, sets)
    ref = composite_along_rays_ref(ts, te, dens.detach(), vals, sets)
    tag = (f"composite_along_rays[R={r},S={s_},D={d},C={len(sets)}"
           f"{',grad' if grad else ''}{f',top{keep}' if keep else ''}]")
    mx = 0.0
    for field, a, b in zip(out._fields, out, ref):
        a = a.detach()
        if field == "median_depth":
            moved = (a != b).squeeze(-1)
            frac = float(moved.float().mean())
            print(f"  {tag}.median_depth: {int(moved.sum())} of {r} rays moved "
                  f"({frac:.2e}); allowed: one sample where cumsum(w) is within 1e-5 of 0.5")
            if moved.any():
                cum = torch.cumsum(ref.weights[..., 0], -1)[moved]
                if float((cum - 0.5).abs().min(-1)[0].max()) > 1e-5:
                    fail(f"{tag}: median depth moved away from a 0.5 crossing")
            continue
        rtol = 1e-4 if field == "depth" else 1e-5
        e, over = compare(f"{tag}.{field}", a, b, rtol, 1e-5)
        mx = max(mx, e)
        if over:
            fail(f"{tag}.{field}: {over} elements over tolerance")
    ms = cuda_ms(lambda: composite_along_rays(ts, te, dens, vals, sets), 20)
    plain_ms = cuda_ms(lambda: composite_along_rays_ref(ts, te, dens.detach(), vals, sets), 10)
    # per sample and density set: alpha, transmittance, weight, depth;
    # a multiply-add per value channel
    n_ops = r * s_ * (12 * d + 2 * len(sets))
    add_entry(kernels_entries, tag, "composite.cu", "emernerf_tpu/render/volrend.py:33",
              composite_along_rays, mx, ms, plain_ms, nbytes(ts, te, dens, vals, *out), n_ops,
              path=path)
    after_timed.append((kernels_entries[-1], K3_FORWARD_KERNELS,
                        remade(lambda: composite_inputs(*args),
                               lambda *a: composite_along_rays(*a, sets)),
                        len(sets) > 64))


def composite_tally(fn):
    """{(R, S, D, C): K3 forward calls} while fn() runs."""
    from emernerf_torch.render import volrend

    tally, inner = {}, volrend._composite_forward

    def counted(t_starts, t_ends, densities, values, chan_set):
        key = (*t_starts.shape, densities.shape[2], len(chan_set))
        tally[key] = tally.get(key, 0) + 1
        return inner(t_starts, t_ends, densities, values, chan_set)

    volrend._composite_forward = counted
    try:
        fn()
    finally:
        volrend._composite_forward = inner
    return tally


# the device kernels of K3 backward (composite.cu), both instances
K3_BACKWARD_KERNELS = ("composite_bwd_kernel",)


def composite_bwd_inputs(dev, seed, s_, with_vals, n_ch=4):
    """Seeded arguments of one K3 backward call of training, 8,192 rays of
    s_ samples and one density set: the pixel branch's final composite
    (``n_ch`` value channels: 4, shadow_ratio^2 and rgb, or 68 with the
    feature head's dino_feat; cotangents of the weights, opacity, depth and
    sums) or a proposal level's (the transmittance's cotangent alone)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.sort(torch.rand((N_TRAIN, s_ + 1), device=dev, generator=g) * 80, -1)[0] + 0.1
    dens = (torch.rand((N_TRAIN, s_, 1), device=dev, generator=g) ** 3 * 0.5).contiguous()
    vals = torch.rand((N_TRAIN, s_, n_ch), device=dev, generator=g) if with_vals else None
    rnd = lambda *shape: torch.randn(shape, device=dev, generator=g)  # noqa: E731
    grads = ((rnd(N_TRAIN, s_, 1), None, rnd(N_TRAIN, 1), rnd(N_TRAIN, 1), rnd(N_TRAIN, n_ch))
             if with_vals else (None, rnd(N_TRAIN, s_, 1), None, None, None))
    sets = [0] * n_ch if with_vals else []
    return t[:, :-1].contiguous(), t[:, 1:].contiguous(), dens, vals, sets, grads


def interlevel_inputs(dev, seed):
    """Seeded K5 inputs of one 8,192-ray branch: (cache edges, cache CDFs)
    of both proposal levels (129 and 65 edges), the final distribution's
    edges (65) and transmittance, and a loss cotangent (2, R).  Edges rise
    strictly from 0 to 1; CDFs are cumsums of U^4 weights scaled to 0.99."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def edges(k1):
        s = torch.cumsum(torch.rand((N_TRAIN, k1), device=dev, generator=g) + 0.05, -1)
        s = s - s[:, :1]
        return (s / s[:, -1:]).contiguous()

    def cdf(k1):
        w = torch.rand((N_TRAIN, k1 - 1), device=dev, generator=g) ** 4
        c = torch.cat([torch.zeros_like(w[:, :1]), torch.cumsum(w, -1)], -1)
        return (c / c[:, -1:] * 0.99).contiguous()

    s_final = edges(NUM_SAMPLES + 1)
    trans_final = (1.0 - cdf(NUM_SAMPLES + 1)[:, :-1]).contiguous()
    caches_s = [edges(n + 1) for n in PROP_SAMPLES]
    cdfs = [cdf(n + 1) for n in PROP_SAMPLES]
    gl = torch.rand((len(PROP_SAMPLES), N_TRAIN), device=dev, generator=g)
    return caches_s, cdfs, s_final, trans_final, gl


def interlevel_bwd_inputs(dev, seed, radii):
    """K5 backward's arguments on interlevel_inputs(dev, seed): the plain
    forward's w_s, the cache CDFs and the loss cotangent."""
    from emernerf_torch.ops.stepfuns import interlevel_loss_levels_ref

    caches_s, cdfs, s_final, trans_final, gl = interlevel_inputs(dev, seed)
    w_s, _ = interlevel_loss_levels_ref(caches_s, cdfs, s_final, trans_final, radii)
    return w_s, cdfs, gl


def k1_backward_row(entries, name, spec, table, pos, pos_grad, g, rays=False, compute=None,
                    path="brick"):
    """K1 backward against its plain version on ``table`` at ``pos`` with a
    random cotangent: the table gradient within rtol 2^-7 (one bf16 ulp) +
    1e-5 x max|grad| (the same fp32 products summed by atomics in another
    order, rounded once to bf16); the position gradient (``pos_grad``) bit
    for bit with the plain version and between two runs.  One kernel line
    of the run ``path``."""
    from emernerf_torch.ops.brickgrid import brickgrid_encode_bwd, brickgrid_encode_bwd_ref

    n = pos.shape[0]
    cot = torch.randn((n, spec.n_output_dims), device=pos.device, generator=g).bfloat16()
    args = (table, pos, cot, spec, pos_grad, compute)
    out, ref = brickgrid_encode_bwd(*args), brickgrid_encode_bwd_ref(*args)
    short = {torch.float32: "fp32", torch.bfloat16: "bf16"}
    label = short[table.dtype]
    if compute is not None and compute != table.dtype:
        label += f"->{short[compute]}"
    tag = (f"brickgrid_encode_bwd[{name}{',warped' if pos_grad else ''}"
           f"{',rays' if rays else ''},{label},N={n}]")
    mx = check(tag + ".d_table", out[0], ref[0], 2 ** -7, 1e-5)
    if pos_grad:
        again = brickgrid_encode_bwd(*args)[1]
        mx = max(mx, float((out[1] - ref[1]).abs().max()))
        exact, repeat = torch.equal(out[1], ref[1]), torch.equal(out[1], again)
        print(f"  {tag}.d_pos: bit for bit with the plain version: {exact}; "
              f"with a second run: {repeat} (tolerance 0)")
        if not (exact and repeat):
            fail(f"{tag}.d_pos: not bit for bit (plain {exact}, second run {repeat})")
        del again
    ms = cuda_ms(lambda: brickgrid_encode_bwd(*args), 5)
    plain_ms = cuda_ms(lambda: brickgrid_encode_bwd_ref(*args), 2)
    # positions and cotangent in, the dense table gradient out (and the
    # touched table entries in, d_pos out, for the position gradient)
    n_bytes = nbytes(pos, cot, out[0], out[1]) + (
        brick_touched(spec, pos) * table.element_size() if pos_grad else 0)
    add_entry(entries, tag, "brickgrid.cu", "emernerf_tpu/ops/brickgrid.py:733",
              brickgrid_encode_bwd, mx, ms, plain_ms, n_bytes,
              grid_ops(spec, n, True, pos_grad), path=path)


def phase_train_kernels(dev, kernels_entries):
    """The training kernels against their plain versions at the shapes of
    one 8,192-ray pixel branch, and K8 over the flagship's parameters."""
    from emernerf_torch.flagship import build_flagship
    from emernerf_torch.train.optim import adam_update, adam_update_ref, make_adam

    g = torch.Generator(device=dev).manual_seed(3)
    specs = flagship_specs()
    print("phase 3 (training): K1 backward and K8 vs plain versions at the shapes "
          f"of one {N_TRAIN}-ray pixel branch")
    # K1 backward, bf16 tables as the flagship trains them, at uniform
    # points and on ray-ordered top-K-like samples (32 per ray, ray-major;
    # the fused grid's warped queries: 16 per ray, the +warp then the -warp
    # third).  Tolerance: the table gradient sums the same fp32 products in
    # another order (atomics) and rounds once to bf16: rtol 2^-7 (one bf16
    # ulp) + 1e-5 x max|grad|; the position gradient repeats the plain
    # version's operations in its order: bit for bit, and bit for bit
    # between two runs
    xyz, xyzt = ray_batches(dev, g, N_TRAIN, SAMPLE_TOPK)
    warped = ray_batches(dev, g, N_TRAIN, AGG_TOPK)[1][N_TRAIN * AGG_TOPK:]
    k1 = [("prop0", None, N_TRAIN * PROP_SAMPLES[0], False),
          ("prop1", None, N_TRAIN * PROP_SAMPLES[1], False),
          ("static", None, N_TRAIN * SAMPLE_TOPK, False),
          ("dynflow", None, N_TRAIN * SAMPLE_TOPK, False),
          ("dynflow", None, 2 * N_TRAIN * AGG_TOPK, True),
          ("static", xyz, N_TRAIN * SAMPLE_TOPK, False),
          ("dynflow", xyzt[:N_TRAIN * SAMPLE_TOPK].contiguous(), N_TRAIN * SAMPLE_TOPK, False),
          ("dynflow", warped.contiguous(), 2 * N_TRAIN * AGG_TOPK, True)]
    del xyzt
    for name, rays, n, pos_grad in k1:
        spec = specs[name]
        pos = (torch.rand((n, spec.n_input_dims), device=dev, generator=g) if rays is None
               else rays)
        table = (torch.rand(spec.table_shape, device=dev, generator=g) * 2 - 1).bfloat16()
        k1_backward_row(kernels_entries, name, spec, table, pos, pos_grad, g,
                        rays=rays is not None)
        del pos, table
    del xyz, warped, k1
    torch.cuda.empty_cache()

    # K8 over every parameter of the full-width flagship, bit for bit
    _, _, model, props, _ = build_flagship(device=dev, seed=0)
    params = [p.detach() for m in (model, *props) for p in m.parameters()]
    del model, props
    adam = make_adam(1e-5)
    h = adam.hyper(3, 0.005)
    mom = adam.init(params)
    pk = [p.clone() for p in params]
    gr = [torch.randn(p.shape, device=dev, generator=g) * 1e-3 for p in params]
    for m_, v_ in zip(mom.mu, mom.nu):
        m_.copy_(torch.randn(m_.shape, device=dev, generator=g) * 1e-3)
        v_.copy_(torch.rand(v_.shape, device=dev, generator=g) * 1e-6)
    mk, vk = [m_.clone() for m_ in mom.mu], [v_.clone() for v_ in mom.nu]
    for p, g_, m_, v_ in zip(pk, gr, mk, vk):
        adam_update(p, g_, m_, v_, h)
    for p, g_, m_, v_ in zip(params, gr, mom.mu, mom.nu):
        adam_update_ref(p, g_, m_, v_, h)
    n = sum(p.numel() for p in params)
    tag = f"adam_update[{len(params)} tensors,{n} elements,bf16 moments for >=2^20]"
    mx = 0.0
    for a, b in ((pk, params), (mk, mom.mu), (vk, mom.nu)):
        for x, y in zip(a, b):
            mx = max(mx, float((x.float() - y.float()).abs().max()))
    print(f"  {tag}: max_abs_err={mx:.3e} over params and moments (tolerance 0: bit for bit)")
    if mx != 0.0:
        fail(f"{tag}: kernel and plain version differ")

    def run(fn):
        def go():
            for p, g_, m_, v_ in zip(pk, gr, mk, vk):
                fn(p, g_, m_, v_, h)
        return go

    ms, plain_ms = cuda_ms(run(adam_update), 5), cuda_ms(run(adam_update_ref), 3)
    # the library's fused Adam (L2 weight decay before the moments, as
    # here) on a copy of the params; it keeps fp32 moments, so it moves
    # 4 bytes more per table element than K8
    lib_params = [p.clone() for p in params]
    for p, g_ in zip(lib_params, gr):
        p.grad = g_
    lib_opt = torch.optim.Adam(lib_params, lr=0.005, betas=(0.9, 0.99), eps=1e-15,
                               weight_decay=1e-5, fused=True)
    library_ms = cuda_ms(lib_opt.step, 5)
    # param, grad and moments read, param and moments written
    n_bytes = sum(nbytes(p, g_, m_, v_) + nbytes(p, m_, v_) for p, g_, m_, v_ in
                  zip(pk, gr, mk, vk))
    add_entry(kernels_entries, tag, "adam.cu", "emernerf_tpu/train/optim.py:33", adam_update,
              mx, ms, plain_ms, n_bytes, 16.0 * n, library_ms=library_ms)
    del params, pk, gr, mom, mk, vk, lib_params, lib_opt
    torch.cuda.empty_cache()


def phase_loss_kernels(dev, kernels_entries, after_timed):
    """K3 backward and K5 (forward and backward, all cache levels in one
    launch) against their plain versions at the calls of one 8,192-ray
    training branch, each also alone after the timed phases."""
    from emernerf_torch.ops.stepfuns import (
        _levels_forward, interlevel_loss_levels, interlevel_loss_levels_bwd,
        interlevel_loss_levels_bwd_ref, interlevel_loss_levels_ref)
    from emernerf_torch.render.volrend import (
        composite_along_rays_bwd, composite_along_rays_bwd_ref)

    print("phase 3 (training): K3 backward and K5 vs plain versions at the calls of one "
          f"{N_TRAIN}-ray branch")
    # K3 backward at the three training calls (composite_bwd_inputs).
    # Tolerance: reverse suffix scans in another order than autograd's: rtol
    # 1e-4 + 1e-5 x max|grad|
    for i, (s_, with_vals) in enumerate(((PROP_SAMPLES[0], False), (PROP_SAMPLES[1], False),
                                         (NUM_SAMPLES, True))):
        args = composite_bwd_inputs(dev, 30 + i, s_, with_vals)
        out = composite_along_rays_bwd(*args)
        ref = composite_along_rays_bwd_ref(*args)
        tag = (f"composite_along_rays_bwd[R={N_TRAIN},S={s_},D=1,"
               f"{'C=4,w/opacity/depth/sums' if with_vals else 'trans'}]")
        mx = check(tag + ".d_dens", out[0], ref[0], 1e-4, 1e-5)
        if with_vals:
            mx = max(mx, check(tag + ".d_vals", out[1], ref[1], 1e-4, 1e-5))
        ms = cuda_ms(lambda: composite_along_rays_bwd(*args), 20)
        plain_ms = cuda_ms(lambda: composite_along_rays_bwd_ref(*args), 5)
        # the forward recomputed, then the reverse scan: ~3x its operations
        n_ops = 3 * N_TRAIN * s_ * (12 + 2 * len(args[4]))
        add_entry(kernels_entries, tag, "composite.cu", "emernerf_tpu/render/volrend.py:33",
                  composite_along_rays_bwd, mx, ms, plain_ms,
                  nbytes(*args[:4], *args[5], *out), n_ops)
        after_timed.append((kernels_entries[-1], K3_BACKWARD_KERNELS,
                            remade(lambda i=i, s_=s_, v=with_vals:
                                   composite_bwd_inputs(dev, 30 + i, s_, v),
                                   composite_along_rays_bwd)))
        del args, out, ref

    # K5, grouped as compute_prop_loss calls it: both cache levels (129 and
    # 65 edges) against the 65-edge final distribution in one launch, each
    # radius at each level.  Tolerance: the blurred pdf is a cumsum of jumps
    # |y| / (2r) that cancel, so fp32 sums in any order sit far from the
    # exact value (tests/test_torch_interlevel.py); each level's w_s and the
    # per-ray losses of the kernel must be as close to a float64 evaluation
    # of the plain version as the fp32 plain version is (2x its max error +
    # 1e-6 x max).  The backward is elementwise on the same w_s: rtol 1e-5 +
    # 1e-6 x max.
    m1s = tuple(n + 1 for n in PROP_SAMPLES)
    for i, radii in enumerate(((0.03, 0.003), (0.003, 0.03))):
        caches_s, cdfs, s_final, trans_final, gl = interlevel_inputs(dev, 20 + i)
        tag = (f"interlevel_loss_levels[R={N_TRAIN},K+1={NUM_SAMPLES + 1},M+1={m1s},"
               f"r={radii}]")
        w_s, loss = _levels_forward(caches_s, cdfs, s_final, trans_final, radii)
        w_ref, loss_ref = interlevel_loss_levels_ref(caches_s, cdfs, s_final, trans_final, radii)
        w64, loss64 = interlevel_loss_levels_ref(
            [x.double() for x in caches_s], [x.double() for x in cdfs], s_final.double(),
            trans_final.double(), radii)
        parts = [(f"w_s[M+1={m1},r={rad}]", *t)
                 for m1, rad, t in zip(m1s, radii, zip(w_s, w_ref, w64))]
        mx = 0.0
        for part, ours, plain, exact in parts + [("loss", loss, loss_ref, loss64)]:
            err = float((ours.double() - exact).abs().max())
            plain_err = float((plain.double() - exact).abs().max())
            mx = max(mx, float((ours - plain).abs().max()))
            print(f"  {tag}.{part}: kernel vs float64 {err:.3e}, plain vs float64 "
                  f"{plain_err:.3e}, kernel vs plain {float((ours - plain).abs().max()):.3e} "
                  f"(max |float64| {float(exact.abs().max()):.3e})")
            if not err <= 2 * plain_err + 1e-6 * float(exact.abs().max()):
                fail(f"{tag}.{part}: the kernel is further from float64 than the plain version")
        mxb = max(check(f"{tag}.d_cdfs[M+1={m1}]", a, b, 1e-5, 1e-6) for m1, a, b in zip(
            m1s, interlevel_loss_levels_bwd(w_ref, cdfs, gl),
            interlevel_loss_levels_bwd_ref(w_ref, cdfs, gl)))
        fwd = (caches_s, cdfs, s_final, trans_final, radii)
        ms = cuda_ms(lambda: interlevel_loss_levels(*fwd), 20)
        plain_ms = cuda_ms(lambda: interlevel_loss_levels_ref(*fwd), 10)
        # per level, a merge of 2K+2 blurred edges, three scans and an
        # interpolation
        k2 = 2 * (NUM_SAMPLES + 1)
        n_ops = sum(N_TRAIN * (k2 * (math.ceil(math.log2(k2)) + 12) + 10 * m1) for m1 in m1s)
        add_entry(kernels_entries, tag, "interlevel.cu", "emernerf_tpu/ops/stepfuns.py:161",
                  interlevel_loss_levels, mx, ms, plain_ms,
                  nbytes(s_final, trans_final, *caches_s, *cdfs, *w_s, loss), n_ops)
        after_timed.append((kernels_entries[-1], ("interlevel_fwd_kernel",),
                            remade(lambda i=i, radii=radii:
                                   interlevel_inputs(dev, 20 + i)[:4] + (radii,),
                                   interlevel_loss_levels)))
        ms = cuda_ms(lambda: interlevel_loss_levels_bwd(w_ref, cdfs, gl), 20)
        plain_ms = cuda_ms(lambda: interlevel_loss_levels_bwd_ref(w_ref, cdfs, gl), 10)
        add_entry(kernels_entries, tag.replace("levels[", "levels_bwd["), "interlevel.cu",
                  "emernerf_tpu/render/prop_sampler.py:133", interlevel_loss_levels_bwd, mxb, ms,
                  plain_ms, nbytes(*w_ref, *cdfs, gl, *cdfs), 4 * N_TRAIN * sum(m1s))
        after_timed.append((kernels_entries[-1], ("interlevel_bwd_kernel",),
                            remade(lambda i=i, radii=radii: interlevel_bwd_inputs(
                                dev, 20 + i, radii), interlevel_loss_levels_bwd)))
        del caches_s, cdfs, s_final, trans_final, gl, w_s, loss, w_ref, loss_ref, w64, loss64
    torch.cuda.empty_cache()


def phase_hash_kernels(dev, kernels_entries):
    """K4 forward and backward against their plain versions at the grids and
    point counts of one 8,192-ray pixel branch of the reference-hash
    flagship (every one of the 64 samples shaded; the current, +warp and
    -warp dynamic queries in one 3N batch with position gradients; the flow
    grid's 3N queries likewise), in bf16 and fp32."""
    from emernerf_torch.ops.hashgrid import (
        features_minor, features_minor_plain, hashgrid_encode, hashgrid_encode_bwd,
        hashgrid_encode_bwd_plain, hashgrid_encode_plain)

    specs = hash_specs()
    n_pts = N_TRAIN * NUM_SAMPLES
    cases = [("static", n_pts, False), ("dynamic", 3 * n_pts, True), ("flow", 3 * n_pts, True),
             ("prop0", N_TRAIN * PROP_SAMPLES[0], False),
             ("prop1", N_TRAIN * PROP_SAMPLES[1], False)]
    g = torch.Generator(device=dev).manual_seed(11)
    print("phase 3 (K4): hash-grid encode forward and backward vs plain versions at the "
          f"reference-hash shapes of one {N_TRAIN}-ray pixel branch")
    # Tolerances: the forward does the plain version's explicitly rounded
    # fp32 operations in its order (fp32: rtol 1e-5; bf16: one rounding,
    # rtol 2^-7), atol 1e-6; the table gradient sums the same fp32 products
    # with atomics in another order (rtol 1e-5 fp32, 2^-7 bf16, + 1e-5 x
    # max|grad|); the position gradient repeats the plain version's order
    # (rtol 1e-5 + 1e-6 x max|grad|)
    for name, n, pos_grad in cases:
        spec = specs[name]
        pos = torch.rand((n, spec.n_input_dims), device=dev, generator=g)
        touched = hash_touched(spec, pos)
        table32 = torch.rand(spec.table_shape, device=dev, generator=g) * 2 - 1
        cot32 = torch.randn((n, spec.n_output_dims), device=dev, generator=g)
        print(f"  {name}: {spec.n_input_dims}D, F={spec.n_features_per_level}, "
              f"{spec.n_levels} levels ({int((~spec.level_uses_hash).sum())} linear), "
              f"T=2^{spec.log2_hashmap_size}; {touched} of {spec.num_parameters} table "
              "elements touched")
        for dtype, rtol in ((torch.bfloat16, 2 ** -7), (torch.float32, 1e-5)):
            table, cot = table32.to(dtype), cot32.to(dtype)
            dt = str(dtype)[6:]
            tag = f"hashgrid_encode[{name},{dt},N={n}]"
            with torch.no_grad():
                out = hashgrid_encode(table, pos, spec)
                ref = hashgrid_encode_plain(table, pos, spec)
                mx, over = compare(tag, out.float(), ref.float(), rtol, 1e-6)
                if over:
                    fail(f"{tag}: {over} elements over tolerance")
                ms = cuda_ms(lambda: hashgrid_encode(table, pos, spec), 10)
                plain_ms = cuda_ms(lambda: hashgrid_encode_plain(table, pos, spec), 3)
            add_entry(kernels_entries, tag, "hashgrid.cu", "emernerf_tpu/ops/hashgrid.py:408",
                      hashgrid_encode, mx, ms, plain_ms,
                      nbytes(pos, out) + touched * table.element_size(),
                      grid_ops(spec, n, False, False), path="hash")
            if spec.n_features_per_level > 1:  # the copy inside that call, alone
                copy_tag = f"features_minor[{name},{dt},{tuple(table.shape)}]"
                exact = torch.equal(features_minor(table), features_minor_plain(table))
                print(f"  {copy_tag}: bit for bit with table.t().contiguous(): {exact}")
                if not exact:
                    fail(f"{copy_tag}: kernel and plain version differ")
                copy_ms = cuda_ms(lambda: features_minor(table), 10)
                # the plain version is one PyTorch call: also the library's
                plain_copy_ms = cuda_ms(lambda: features_minor_plain(table), 10)
                add_entry(kernels_entries, copy_tag, "hashgrid.cu",
                          "emernerf_tpu/ops/hashgrid.py:408", features_minor, 0.0, copy_ms,
                          plain_copy_ms, 2 * nbytes(table), 0.0, library_ms=plain_copy_ms,
                          path="hash")
            tag = f"hashgrid_encode_bwd[{name}{',pos_grad' if pos_grad else ''},{dt},N={n}]"
            got = hashgrid_encode_bwd(table, pos, cot, spec, pos_grad)
            want = hashgrid_encode_bwd_plain(table, pos, cot, spec, pos_grad)
            mx = check(tag + ".d_table", got[0], want[0], rtol, 1e-5)
            if pos_grad:
                mx = max(mx, check(tag + ".d_pos", got[1], want[1], 1e-5, 1e-6))
            ms = cuda_ms(lambda: hashgrid_encode_bwd(table, pos, cot, spec, pos_grad), 5)
            plain_ms = cuda_ms(lambda: hashgrid_encode_bwd_plain(table, pos, cot, spec,
                                                                 pos_grad), 2)
            n_bytes = nbytes(pos, cot, *got) + (touched * table.element_size() if pos_grad else 0)
            add_entry(kernels_entries, tag, "hashgrid.cu", "emernerf_tpu/ops/hashgrid.py:415",
                      hashgrid_encode_bwd, mx, ms, plain_ms, n_bytes,
                      grid_ops(spec, n, True, pos_grad), path="hash")
            if pos_grad:  # the share of the position gradient's table re-read
                kernels_entries[-1]["table_grad_only_ms"] = cuda_ms(
                    lambda: hashgrid_encode_bwd(table, pos, cot, spec, False), 5)
                print(f"  {tag}: without the position gradient "
                      f"{kernels_entries[-1]['table_grad_only_ms']:.3f} ms")
            del out, ref, got, want
        del pos, table32, cot32, table, cot
        torch.cuda.empty_cache()

    # the same grids on ray-ordered samples (8,192 rays; the dynamic grid's
    # 3N batch, the flow grid's warped 2N), bf16 as the flagship trains:
    # neighbouring lanes on the same rows, K4 forward's shared sectors and
    # K4 backward's warp merge at work
    print(f"phase 3 (K4, rays): K4 forward and backward on ray-ordered samples of {N_TRAIN} "
          "rays, bf16")
    xyz, xyzt = ray_batches(dev, g, N_TRAIN, NUM_SAMPLES)
    rays = {"static": (xyz, False), "dynamic": (xyzt, True),
            "flow": (xyzt[n_pts:].contiguous(), True),
            "prop0": (ray_batches(dev, g, N_TRAIN, PROP_SAMPLES[0])[0], False),
            "prop1": (ray_batches(dev, g, N_TRAIN, PROP_SAMPLES[1])[0], False)}
    del xyz, xyzt
    for name, (pos, pos_grad) in rays.items():
        spec, n = specs[name], pos.shape[0]
        stats = warp_rows(spec, pos)
        print(f"  {name}: per level, distinct rows / runs of equal rows per warp and corner "
              f"(of 32 lanes): " + ", ".join(f"{d:.1f}/{r:.1f}" for d, r in stats))
        table = (torch.rand(spec.table_shape, device=dev, generator=g) * 2 - 1).bfloat16()
        cot = torch.randn((n, spec.n_output_dims), device=dev, generator=g).bfloat16()
        touched = hash_touched(spec, pos) * table.element_size()
        tag = f"hashgrid_encode[{name},rays,bf16,N={n}]"
        with torch.no_grad():
            out = hashgrid_encode(table, pos, spec)
            mx, over = compare(tag, out.float(), hashgrid_encode_plain(table, pos, spec).float(),
                               2 ** -7, 1e-6)
            if over:
                fail(f"{tag}: {over} elements over tolerance")
            ms = cuda_ms(lambda: hashgrid_encode(table, pos, spec), 10)
            plain_ms = cuda_ms(lambda: hashgrid_encode_plain(table, pos, spec), 3)
        add_entry(kernels_entries, tag, "hashgrid.cu", "emernerf_tpu/ops/hashgrid.py:408",
                  hashgrid_encode, mx, ms, plain_ms, nbytes(pos, out) + touched,
                  grid_ops(spec, n, False, False), path="hash")
        tag = f"hashgrid_encode_bwd[{name}{',pos_grad' if pos_grad else ''},rays,bf16,N={n}]"
        got = hashgrid_encode_bwd(table, pos, cot, spec, pos_grad)
        want = hashgrid_encode_bwd_plain(table, pos, cot, spec, pos_grad)
        mx = check(tag + ".d_table", got[0], want[0], 2 ** -7, 1e-5)
        if pos_grad:
            mx = max(mx, check(tag + ".d_pos", got[1], want[1], 1e-5, 1e-6))
        ms = cuda_ms(lambda: hashgrid_encode_bwd(table, pos, cot, spec, pos_grad), 5)
        plain_ms = cuda_ms(lambda: hashgrid_encode_bwd_plain(table, pos, cot, spec, pos_grad), 2)
        add_entry(kernels_entries, tag, "hashgrid.cu", "emernerf_tpu/ops/hashgrid.py:415",
                  hashgrid_encode_bwd, mx, ms, plain_ms,
                  nbytes(pos, cot, *got) + (touched if pos_grad else 0),
                  grid_ops(spec, n, True, pos_grad), path="hash")
        del out, got, want, table, cot
        torch.cuda.empty_cache()


def _profile_name(profile) -> str:
    cfile = os.path.relpath(profile.config_file, REPO) if profile.config_file else "defaults"
    return " ".join([cfile, *profile.overrides])


def _check_launches(launches, zero, what):
    """Every counted kernel launched, none of ``zero`` did."""
    for name, n in launches.items():
        if name in zero and n != 0:
            fail(f"kernel {name} was launched {n} times by the {what}; its path must not run it")
        if name not in zero and n <= 0:
            fail(f"kernel {name} was not launched by the {what}")


def phase_slice(dev, counted, zero=(), profile=None, label="phase 4", flow=True, overrides=()):
    from emernerf_torch.eval.renderer import ImageRenderer
    from emernerf_torch.flagship import DEFAULT_PROFILE, build_flagship

    profile = profile or DEFAULT_PROFILE
    print(f"{label}: full-width flagship eval render (bf16 default dtypes, profile "
          f"{_profile_name(profile)}{''.join(' ' + o for o in overrides)})")
    t0 = time.perf_counter()
    cfg, dataset, model, props, _ = build_flagship(overrides=overrides, profile=profile,
                                                   device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters()) + sum(
        p.numel() for pm in props for p in pm.parameters())
    print(f"  built flagship: {n_params} params in {time.perf_counter() - t0:.1f} s; "
          f"table_dtype={cfg.nerf.model.table_dtype} mlp_dtype={cfg.nerf.model.mlp_dtype}")
    kw = dict(num_samples=cfg.nerf.sampling.num_samples,
              prop_samples=tuple(cfg.nerf.propnet.num_samples_per_prop),
              near_plane=cfg.nerf.propnet.near_plane, far_plane=cfg.nerf.propnet.far_plane,
              sampling_type=cfg.nerf.propnet.sampling_type,
              return_decomposition=model.has_dynamic, device=dev)
    renderer = ImageRenderer(model, props, chunk_size=cfg.render.render_chunk_size, **kw)
    indices = [0, 1]
    renderer.render_image(*_image_rays(dataset, 0))  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    for fn in counted + tuple(zero):
        fn.launches = 0
    t0 = time.perf_counter()
    frames, metrics = renderer.render_split(dataset, indices)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted + tuple(zero)}
    h, w = dataset.image_hw
    n_rays = len(indices) * h * w
    print(f"  render_split: {len(indices)} images of {h}x{w} = {n_rays} rays in {secs:.3f} s "
          f"-> {n_rays / secs:.1f} rays/s (chunk {renderer.chunk_size}, incl. host copies)")
    print(f"  metrics (random weights): {metrics}")
    print(f"  launch counts in the render: {launches}")
    for i, maps in enumerate(frames):
        for k, v in maps.items():
            if not np.isfinite(v).all():
                fail(f"image {indices[i]}: map {k} is not finite")
        if maps["rgb"].shape != (h, w, 3) or maps["depth"].shape != (h, w):
            fail(f"image {indices[i]}: unexpected map shapes")
    print(f"  maps finite: {sorted(frames[0])}")
    if ("forward_flow" in frames[0]) != flow:
        fail(f"flow maps {'missing' if flow else 'present'}: {sorted(frames[0])}")
    _check_launches(launches, {fn.__name__ for fn in zero}, "render")
    tally = composite_tally(lambda: renderer.render_image(*_image_rays(dataset, 0)))
    print(f"  K3 forward calls by (R, S, D, C) in one more image: {tally}")
    del model, props, renderer
    torch.cuda.empty_cache()
    return launches, n_rays / secs, tally


def _image_rays(dataset, idx):
    rays, gt = dataset.get_image_rays(idx)
    return rays, gt["hw"]


def _scaled_twins(gpu, cpu):
    """Scale the card models' tables up from their U(+-1e-4) init, so that
    density varies along and across rays (random MLPs alone give a
    near-constant depth), and copy every param to the CPU models."""
    with torch.no_grad():
        for pm in gpu:
            for name, p in pm.named_parameters():
                if name.endswith("table"):
                    p.mul_(TABLE_SCALE)
    for c, g in zip(cpu, gpu):
        c.load_state_dict(g.state_dict())


def phase_fp32_chunk(dev, overrides=(), profile=None, label="phase 4b", time_=None,
                     n_rays=2048):
    """One chunk of ``n_rays`` across the first image's middle rows in fp32,
    the full-width flagship of ``profile`` with ``overrides`` on the card
    against the same params on the CPU; ``time_`` sets the rays' normalized
    time.  Returns the card's and the CPU's models and renderers' kwargs
    for a further check."""
    from emernerf_torch.eval.renderer import ImageRenderer
    from emernerf_torch.flagship import DEFAULT_PROFILE, build_flagship

    profile = profile or DEFAULT_PROFILE
    print(f"{label}: one {n_rays}-ray chunk in fp32, card (kernels) vs CPU (plain versions); "
          f"profile {_profile_name(profile)}{''.join(' ' + o for o in overrides)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fp32 = ["nerf.model.table_dtype=float32", "nerf.model.mlp_dtype=float32", *overrides]
    cfg, dataset, gmodel, gprops, _ = build_flagship(overrides=fp32, profile=profile, device=dev,
                                                     seed=1)
    _, _, cmodel, cprops, _ = build_flagship(overrides=fp32, profile=profile, device="cpu",
                                             seed=1)
    _scaled_twins([gmodel, *gprops], [cmodel, *cprops])
    rays, _ = dataset.get_image_rays(0)
    h, w = dataset.image_hw
    sl = slice(w * (h // 2), w * (h // 2) + n_rays)  # rays across the image's middle rows
    rays = {k: v[sl] for k, v in rays.items()}
    if time_ is not None:
        rays["normed_timestamps"] = np.full_like(rays["normed_timestamps"], time_)
    kw = dict(num_samples=cfg.nerf.sampling.num_samples,
              prop_samples=tuple(cfg.nerf.propnet.num_samples_per_prop),
              near_plane=cfg.nerf.propnet.near_plane, far_plane=cfg.nerf.propnet.far_plane,
              sampling_type=cfg.nerf.propnet.sampling_type, chunk_size=n_rays,
              return_decomposition=True)
    out_gpu = ImageRenderer(gmodel, gprops, device=dev, **kw).render_rays_chunked(rays)
    t0 = time.perf_counter()
    out_cpu = ImageRenderer(cmodel, cprops, device="cpu", **kw).render_rays_chunked(rays)
    print(f"  CPU plain render of {n_rays} rays: {time.perf_counter() - t0:.1f} s")
    rgb_err = float(np.abs(out_gpu["rgb"] - out_cpu["rgb"]).max())
    depth_rel = float((np.abs(out_gpu["depth"] - out_cpu["depth"])
                       / np.maximum(np.abs(out_cpu["depth"]), 1e-3)).max())
    print(f"  fp32 chunk: rgb max abs diff {rgb_err:.3e} (tolerance 1e-3); "
          f"depth max rel diff {depth_rel:.3e} (tolerance 1e-3); "
          f"depth range [{out_cpu['depth'].min():.3f}, {out_cpu['depth'].max():.3f}]")
    for k in out_gpu:
        d = float(np.abs(out_gpu[k] - out_cpu[k]).max())
        print(f"    {k}: max abs diff {d:.3e}")
    if not (rgb_err <= 1e-3 and depth_rel <= 1e-3):
        fail(f"{label}: fp32 chunk on the card disagrees with the CPU plain render")
    return dataset, (gmodel, gprops), (cmodel, cprops), kw, rays


def _losses(metrics):
    return {k: float(v) for k, v in metrics.items()
            if "loss" in k or k in ("psnr", "lidar_line_of_sight")}


def profile_shares(rows, busy, shares=PROFILE_SHARES):
    """{label: share of the device busy time} for each (label, kernel-name
    substrings) of ``shares``; rows are (name, ms, count) over the profiled
    iterations, busy the device ms per iteration (2 iterations)."""
    return {what: sum(t for k, t, _ in rows if any(x in k for x in keys)) / 2 / busy
            for what, keys in shares}


def table_casts(trainer, step, numels):
    """Every dtype cast, during one training iteration, of a tensor with as
    many elements as a grid table: (op, elements, from dtype, to dtype).
    An aten-level dispatch mode sees the forward's and the backward's ops."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []
    ops = (torch.ops.aten._to_copy.default, torch.ops.aten.copy_.default)

    class Casts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in ops:
                src, dst = (args[0], out) if func is ops[0] else (args[1], args[0])
                if (src.dtype != dst.dtype and src.dtype.is_floating_point
                        and dst.dtype.is_floating_point and src.numel() in numels):
                    seen.append((func.__name__, src.numel(), str(src.dtype)[6:],
                                 str(dst.dtype)[6:]))
            return out

    with Casts():  # the mode sees each op as the host issues it
        trainer.train_iteration(step)
    return seen


# the launch counters that phase 5 and 6 read per window of iterations:
# K5 forward and backward, K3 backward
LOSS_LAUNCHES = ("interlevel_loss_levels", "interlevel_loss_levels_bwd",
                 "composite_along_rays_bwd")


def _launch_snapshot(counted):
    return {fn.__name__: fn.launches for fn in counted if fn.__name__ in LOSS_LAUNCHES}


def _check_loss_launches(windows, history, n_timed):
    """Prints the K5 and K3 backward launches of the timed steps 3-14 (on
    the proposal-gradient schedule's ramp, every render after the first
    takes proposal gradients) and of iterations 2000-2001 (steady state:
    one render in six does), beside the renders that took them; fails
    unless K5 launched once forward and once backward per such render (all
    cache levels in one launch)."""
    names = [("timed steps 3-14" if n_timed == 12 else f"timed steps 3-{2 + n_timed}",
              history[3:3 + n_timed]), ("iterations 2000-2001", history[3 + n_timed:])]
    for (label, its), before, after in zip(names, windows, windows[1:]):
        rg = sum(int(bool(m["pixel_rg"])) + int(bool(m["lidar_rg"])) for m in its)
        got = {k: after[k] - before[k] for k in after}
        print(f"  launches over {label} ({len(its)} iterations, {rg} renders with proposal "
              f"gradients): {got}; K3 backward expected 2 per iteration + 2 per such render "
              f"= {2 * len(its) + 2 * rg}")
        for k in LOSS_LAUNCHES[:2]:
            if k in got and got[k] != rg:
                fail(f"{k}: {got[k]} launches over {label}, {rg} renders with proposal "
                     "gradients (one launch per render for all cache levels)")


def phase_train(dev, counted, zero=(), profile=None, n_timed=12, label="phase 5",
                profile_file="profile_train.json", shares=(), table_casts_allowed=True,
                flow=True):
    """Trains the full-width flagship of ``profile`` through Trainer;
    returns (launches, ms/iteration, rays/s, peak GiB, {label: share of the
    profiled device time} for each (label, kernel-name substrings) of
    ``shares``, {(R, S, D, C): K3 forward calls in one iteration}).  Lists
    the casts of tensors the size of a grid table in one more iteration,
    and fails on any unless ``table_casts_allowed``; fails unless the model
    has a flow branch (flow outputs and the cycle loss) exactly when
    ``flow``."""
    from emernerf_torch.flagship import DEFAULT_PROFILE, flagship_config
    from emernerf_torch.train.trainer import Trainer

    profile = profile or DEFAULT_PROFILE
    print(f"{label}: full-width flagship training through Trainer (bf16 default dtypes, "
          f"seed 0, profile {_profile_name(profile)})")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    trainer = Trainer(flagship_config(profile=profile), device=dev)
    params = trainer.state.params + trainer.state.prop_params
    n_params = sum(p.numel() for p in params)
    table_numels = {p.numel() for m in (trainer.model, *trainer.prop_models)
                    for name, p in m.named_parameters() if name.endswith("table")}
    if trainer.model.has_flow != flow or trainer.step_cfg.has_flow != flow:
        fail(f"the model's flow branch: {trainer.model.has_flow}, expected {flow}")
    cfg = trainer.step_cfg
    print(f"  built: {n_params} params in {time.perf_counter() - t0:.1f} s; "
          f"{trainer.ray_batch_size} pixel + {trainer.ray_batch_size} lidar rays, "
          f"sample_topk {cfg.sample_topk} (temp {cfg.sample_topk_temp}), lidar "
          f"{cfg.lidar_sample_topk}, prop samples {cfg.prop_samples}, {cfg.num_samples} samples")
    before = [p.detach().clone() for p in params]
    for fn in counted + tuple(zero):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    history = []
    for step in range(3):  # warm-up: cuBLAS, allocator
        history.append(trainer.train_iteration(step))
    torch.cuda.synchronize()
    windows = [_launch_snapshot(counted)]
    t0 = time.perf_counter()
    for step in range(3, 3 + n_timed):
        history.append(trainer.train_iteration(step))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_timed
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    windows.append(_launch_snapshot(counted))
    # an error-map refresh at iteration 2000, then the line-of-sight loss
    # (live after supervision.depth.line_of_sight.start_iter) with buffered
    # pixel sampling
    trainer.state.step = 2000
    history.append(trainer.train_iteration(2000))
    history.append(trainer.train_iteration(2001))
    torch.cuda.synchronize()
    windows.append(_launch_snapshot(counted))
    _check_loss_launches(windows, history, n_timed)
    launches = {fn.__name__: fn.launches for fn in counted + tuple(zero)}
    rows, busy = profile_train(trainer, 2002, ms, profile_file)
    share = profile_shares(rows, busy, shares)
    for what, keys in shares:
        print(f"  {what}: {share[what]:.1%} of the device time, {share[what] * busy:.3f} ms "
              f"per iteration (kernels {', '.join(keys)})")
    casts = table_casts(trainer, 2004, table_numels)
    print(f"  dtype casts of tensors the size of a grid table ({sorted(table_numels)} "
          f"elements) in one iteration: {len(casts)} {casts[:12]}")
    if casts and not table_casts_allowed:
        fail(f"{len(casts)} casts of a grid table in one training iteration: {casts[:6]}")
    tally = composite_tally(lambda: trainer.train_iteration(2005))
    print(f"  K3 forward calls by (R, S, D, C) in one more iteration: {tally}")
    rays = 2 * trainer.ray_batch_size
    print(f"  {ms:.2f} ms/iteration (mean over {n_timed} timed iterations), "
          f"{rays / ms * 1e3:.1f} rays/s (pixel + lidar), peak device memory {peak:.2f} GiB")
    for i, m in enumerate(history):
        losses = _losses(m)
        if not all(np.isfinite(v) for v in losses.values()):
            fail(f"iteration {i}: non-finite loss {losses}")
        if ("cycle_loss" in m) != flow:
            fail(f"iteration {i}: cycle loss {'missing' if flow else 'present'} ({sorted(m)})")
    rg = [(bool(m["pixel_rg"]), bool(m["lidar_rg"])) for m in history]
    print(f"  requires-grad (pixel, lidar) per iteration: {rg}")
    if not any(a or b for a, b in rg) or all(a and b for a, b in rg):
        fail("the run needs both requires-grad and non-requires-grad renders")
    if not trainer.error_map_buffered or float(history[-1]["lidar_line_of_sight"]) <= 0:
        fail("the error-map refresh or the line-of-sight loss did not run")
    print(f"  losses at iteration 0: {_losses(history[0])}")
    print(f"  losses at iteration 2001: {_losses(history[-1])}")
    unchanged = [i for i, (p, b) in enumerate(zip(params, before)) if torch.equal(p, b)]
    if unchanged:
        fail(f"{len(unchanged)} parameter tensors did not change")
    print(f"  all {len(params)} parameter tensors changed; launch counts: {launches}")
    _check_launches(launches, {fn.__name__ for fn in zero}, "training run")
    del trainer, params, before
    torch.cuda.empty_cache()
    return launches, ms, rays / ms * 1e3, peak, share, tally


def phase_composite_shapes(dev, entries, after_timed, tallies):
    """K3 forward against its plain version at every (R, S, D, C) that the
    training and eval runs of phases 4-10 launched, called as each run
    calls it; ``tallies`` holds (tally, path, grad) per run: a shape's
    kernel line reports the launches of the training run ``path`` of its
    first run.  Phase 3's eval key set is not repeated."""
    print("phase 11: K3 forward vs plain version at every shape the training and eval runs "
          "launched")
    seen = {(N_RAYS, NUM_SAMPLES, 3, 23, False)}
    for tally, path, grad in tallies:
        for r, s_, d, c in sorted(tally):
            if (r, s_, d, c, grad) in seen:
                continue
            seen.add((r, s_, d, c, grad))
            composite_row(dev, 7 + len(seen), entries, after_timed, r, s_, d,
                          [j % d for j in range(c)], 80.0, path=path, grad=grad)
    torch.cuda.empty_cache()


def profile_train(trainer, step, ms_iter, file_name):
    """Device time by kernel over 2 training iterations (torch.profiler,
    CUDA activity only: tracing CPU ops slows the iteration ~40x)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof = cuda_profile(lambda: [trainer.train_iteration(step + i) for i in range(2)])
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 2
    print(f"  profile of 2 iterations: device busy {busy:.2f} ms per iteration = "
          f"{busy / ms_iter:.3f} of the unprofiled {ms_iter:.2f} ms (wall under the profiler "
          f"{wall_ms / 2:.2f} ms); top device-time items per iteration:")
    for key, t, n in rows[:25]:
        print(f"    {t / 2:8.3f} ms {t / 2 / busy:6.1%} {n // 2:5d}x  {key[:100]}")
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, file_name), "w") as f:
        json.dump(dict(ms_per_iteration=ms_iter, busy_ms_per_iteration=busy,
                       profiled_wall_ms_per_iteration=wall_ms / 2,
                       rows=[dict(name=k, ms_per_iteration=t / 2, count=n) for k, t, n in rows]),
                  f, indent=1)
    return rows, busy


def phase_train_fp32(dev, profile=None, overrides=TINY_FP32, label="phase 5b"):
    from emernerf_torch.data.scene import draw_lidar, draw_pixel, sample_lidar_batch, sample_pixel_batch
    from emernerf_torch.flagship import DEFAULT_PROFILE, build_flagship
    from emernerf_torch.train.step import build_train_step, draw_step

    profile = profile or DEFAULT_PROFILE
    print(f"{label}: one fp32 training step of the tiny flagship (profile "
          f"{_profile_name(profile)}), card (kernels) vs CPU (plain)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, dataset, gmodel, gprops, scfg = build_flagship(tiny=True, overrides=overrides,
                                                      profile=profile, device=dev, seed=2)
    _, _, cmodel, cprops, _ = build_flagship(tiny=True, overrides=overrides, profile=profile,
                                             device="cpu", seed=2)
    _scaled_twins([gmodel, *gprops], [cmodel, *cprops])
    gstep, cstep = build_train_step(gmodel, gprops, scfg), build_train_step(cmodel, cprops, scfg)
    scene = dataset.scene_tensors("cpu")
    gen = torch.Generator().manual_seed(5)
    r = 256
    pixel = sample_pixel_batch(scene, draw_pixel(scene, r, gen))
    lidar = sample_lidar_batch(scene, draw_lidar(scene, r, gen))
    to = lambda x: None if x is None else x.to(dev)  # noqa: E731

    def on(batch, draws, device):
        if device == "cpu":
            return batch, draws
        return ({k: v.to(dev) for k, v in batch.items()},
                draws._replace(jitters=tuple(map(to, draws.jitters)), topk_u=to(draws.topk_u),
                               agg_noise=to(draws.agg_noise)))

    # tolerances as in tests/test_torch_train_step.py: losses rtol 1e-4
    # (sky loss 1e-3); gradients rtol 1e-3 + 2e-3 x the tensor's max |grad|
    worst = 0.0
    for lidar_branch in (False, True):
        batch = lidar if lidar_branch else pixel
        draws = draw_step(r, gstep.render_kw(lidar_branch), gmodel.has_flow, gen)
        got = []
        for step, model, props, device in ((gstep, gmodel, gprops, dev),
                                           (cstep, cmodel, cprops, "cpu")):
            loss_fn = step.lidar_loss if lidar_branch else step.pixel_loss
            b, d = on(batch, draws, device)
            total, aux = loss_fn(b, d, 0, True)
            total.backward()
            named = [(f"{i}.{n}" if i >= 0 else n, p) for i, m in
                     enumerate([model] + list(props), start=-1) for n, p in m.named_parameters()]
            got.append(({k: float(v.detach()) for k, v in aux.items()},
                        {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                         for n, p in named}))
            for _, p in named:
                p.grad = None
        (gl, gg), (cl, cg) = got
        branch = "lidar" if lidar_branch else "pixel"
        for k, v in cl.items():
            rtol = 1e-3 if k == "sky_loss" else 1e-4
            if not np.isclose(gl[k], v, rtol=rtol, atol=1e-7):
                fail(f"{branch} {k}: card {gl[k]} vs CPU {v}")
        for name, ref in cg.items():
            err = float((gg[name] - ref).abs().max())
            scale = float(ref.abs().max())
            worst = max(worst, err / max(scale, 1e-30))
            if (gg[name] - ref).abs().gt(2e-3 * scale + 1e-3 * ref.abs()).any():
                fail(f"{branch} gradient {name}: max abs err {err:.3e} (max |grad| {scale:.3e})")
        print(f"  {branch} branch: losses {cl}")
    print(f"  all losses and {len(cg)} gradients match; worst gradient error "
          f"{worst:.3e} x the tensor's max |grad|")


def kernel_only(after_timed):
    """Each (entry, kernel-name substrings, call[, queued]) of
    ``after_timed``: the device time of the kernels alone in the call, a
    torch.profiler session each, run after every timed phase so that no
    profiler session precedes the eval, training and CLI timings.  With
    ``queued`` (K3 past 64 channels) queued_ms's time of the call is
    printed beside it."""
    print("kernels alone (torch.profiler, after the timed phases; kernel records per call)")
    while after_timed:  # each call's inputs go with it
        entry, keys, fn, *queued = after_timed.pop(0)
        ms, records = profiled_ms(fn, keys, iters=20)
        extra = f"; queued events {queued_ms(fn, 20):.4f} ms" if queued and queued[0] else ""
        print(f"  {entry['name']}: the wrapper's call {entry['ms']:.4f} ms, the kernel alone "
              f"{set_kernel_only(entry, ms)} ({records / 20:g} records a call{extra})")


def set_kernel_only(entry, ms) -> str:
    """entry's kernel_only_ms = ms, unless the session kept no record or ms
    is under the HBM bound (inputs that stay in the L2 between calls, or a
    fault of the measurement): then none."""
    if ms is None or ms < entry["bound_ms"]:
        entry.pop("kernel_only_ms", None)
        return f"not reported ({'no records' if ms is None else f'{ms:.4f} ms, under the bound'})"
    entry["kernel_only_ms"] = ms
    return f"{ms:.4f} ms"


def cuda_profile(run):
    """torch.profiler's CUDA activity over run() and a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return prof


def profiled_ms(fn, keys, iters=10):
    """(device time per call of fn() in the kernels whose names contain one
    of keys, their records) from torch.profiler.  Each such kernel runs once
    per call, so its time is its mean over its records: in a long process a
    session keeps only some of them (8 of 20 lost is common; PERF.md, PR
    12), and a lost record does not bias the mean; (None, 0) where the
    session kept none."""
    fn()
    torch.cuda.synchronize()
    prof = cuda_profile(lambda: [fn() for _ in range(iters)])
    hits = [e for e in prof.key_averages()
            if e.device_time_total > 0 and any(k in e.key for k in keys)]
    if not hits:
        return None, 0
    return (sum(e.device_time_total / e.count for e in hits) / 1e3,
            sum(e.count for e in hits))


def kernel_device_ms(fn, keys, iters=10):
    """Device time per call of fn() in the kernels whose names contain one
    of keys, each launched once per call (profiled_ms); None without records."""
    return profiled_ms(fn, keys, iters)[0]


def phase_probes(dev, entries, after_timed):
    """P1-P4: both probe entry points at their full sizes (the launches of
    the probe path), then each kernel against its plain version at every
    shape the entry points run."""
    from emernerf_torch.ops import gather_scatter as gs
    from emernerf_torch.perf import bench_scatter_alts, bench_scatter_rmw, pallas_experiments as pe

    fns = (gs.row_gather_loop, gs.row_gather_take, gs.scatter_add_rmw, gs.scatter_add_onehot)
    print("phase 7: the gather/scatter probe entry points (P1-P4), full sizes")
    for fn in fns:
        fn.launches = 0
    t0 = time.perf_counter()
    pe.main([])
    bench_scatter_alts.main([])
    launches = {fn.__name__: fn.launches for fn in fns}
    print(f"  both entry points in {time.perf_counter() - t0:.1f} s; launch counts: {launches}")
    _check_launches(launches, (), "probe run")

    def add(tag, fn, replaces, mx, run, plain, library, n, n_bytes, n_ops, extra=None):
        ms, plain_ms, library_ms = cuda_ms(run, 10), cuda_ms(plain, 10), cuda_ms(library, 10)
        print(f"  {tag}: {n / ms / 1e3:.1f} Mrows/s, {n_bytes / ms / 1e6:.1f} GB/s")
        add_entry(entries, tag, "gather_scatter.cu", replaces, fn, mx, ms, plain_ms, n_bytes,
                  n_ops, library_ms=library_ms, path="probe")
        entries[-1].update(extra or {})

    print("phase 7 (kernels): P1-P4 vs plain versions at every shape of the entry points")
    n = pe.N
    gathers = [(gs.row_gather_loop, "perf/pallas_experiments.py:60", 1 << 14, torch.float32),
               (gs.row_gather_loop, "perf/pallas_experiments.py:60", 1 << 15, torch.bfloat16),
               (gs.row_gather_take, "perf/pallas_experiments.py:94", 1 << 14, torch.float32)]
    for fn, replaces, t, dtype in gathers:
        table, idx = pe.make_table(t, 128, dtype, dev), pe.make_indices(n, t, dev)
        tag = f"{fn.__name__}[t={t},w=128,{str(dtype)[6:]},n={n}]"
        out, ref = fn(table, idx), gs.row_gather_plain(table, idx)
        exact = torch.equal(out, ref)
        print(f"  {tag}: bit for bit with index_select: {exact}")
        if not exact:
            fail(f"{tag}: kernel and plain version differ")
        n_bytes = nbytes(table, idx, out)
        del out, ref
        add(tag, fn, replaces, 0.0, lambda: fn(table, idx), lambda: gs.row_gather_plain(table, idx),
            lambda: table.index_select(0, idx), n, n_bytes, 0.0)
        if fn is gs.row_gather_loop:
            after_timed.append((entries[-1], ("gather_loop_kernel",), remade(
                lambda t=t, dtype=dtype: (pe.make_table(t, 128, dtype, dev),
                                          pe.make_indices(n, t, dev)), fn)))
        del table, idx
        torch.cuda.empty_cache()

    # P3 and P4: fp32 sums in another order (atomics) than index_add_'s:
    # within 1e-5 of the largest |value|.  P3 at the entry point's shape,
    # then at odd widths (float and float2 reductions), on an update view
    # at a 4-byte offset (p3_plan narrows) and with every index 0 (the
    # worst contention), each with its kernel's time alone
    # (the shapes of bench_scatter_rmw, which times P3 alone)
    t = bench_scatter_rmw.T
    for rows, w, offset, equal in bench_scatter_rmw.SHAPES:
        idx, upd = bench_scatter_rmw.make_inputs(dev, rows, w, offset, equal)
        tag = bench_scatter_rmw.tag(rows, w, offset, equal)
        out = gs.scatter_add_rmw(idx, upd, t)
        vec = gs.p3_plan(w, upd.data_ptr(), out.data_ptr())
        mx = check(tag, out, gs.scatter_add_plain(idx, upd, t), 0.0, 1e-5)
        add(tag, gs.scatter_add_rmw, "perf/pallas_experiments.py:124", mx,
            lambda: gs.scatter_add_rmw(idx, upd, t), lambda: gs.scatter_add_plain(idx, upd, t),
            lambda: torch.zeros((t, w), device=dev).index_add_(0, idx, upd), rows,
            nbytes(idx, upd, out), float(rows * w), {"p3_vec_bytes": vec})
        e = entries[-1]
        alone = set_kernel_only(e, kernel_device_ms(lambda: gs.scatter_add_rmw(idx, upd, t),
                                                    ("scatter_rmw_kernel",)))
        share = f"{e['bound_ms'] / e['kernel_only_ms']:.1%}" if "kernel_only_ms" in e else "-"
        print(f"  {tag}: {vec}-byte reductions; kernel alone {alone}, the call {e['ms']:.4f} "
              f"ms, plain {e['plain_ms']:.4f} ms, index_add_ {e['library_ms']:.4f} ms; bound "
              f"{e['bound_ms']:.4f} ms = {share} of the time alone, "
              f"{e['bound_ms'] / e['ms']:.1%} of the call's")
        del idx, upd, out
    torch.cuda.empty_cache()
    nn = bench_scatter_alts.N
    for t, w, tile_n in bench_scatter_alts.PALLAS_SHAPES:
        rows, upd = bench_scatter_alts.make_inputs(nn, t, w, dev)
        route = gs.p4_plan(t, w)
        tag = f"scatter_add_onehot[T={t},W={w},tile_n={tile_n},N={nn}]"
        out = gs.scatter_add_onehot(rows, upd, t, tile_n)
        mx = check(tag, out, gs.scatter_add_onehot_plain(rows, upd, t), 0.0, 1e-5)
        upd_bf = upd.bfloat16().float()
        matmul_ms = cuda_ms(lambda: bench_scatter_alts.onehot_matmul(rows, upd, t), 5)
        print(f"  {tag}: library one-hot torch.matmul (bf16, fp32 sums) {matmul_ms:.3f} ms")
        print(f"  {tag}: route {route} (table {4 * t * w} bytes, shared memory "
              f"{gs.SMEM_BYTES})")
        # the bound of the work, a scatter-add of these rows, not of the
        # one-hot product's 2*T*N*W FLOPs
        add(tag, gs.scatter_add_onehot, "perf/bench_scatter_alts.py:196", mx,
            lambda: gs.scatter_add_onehot(rows, upd, t, tile_n),
            lambda: gs.scatter_add_onehot_plain(rows, upd, t),
            lambda: torch.zeros((t, w), device=dev).index_add_(0, rows, upd_bf), nn,
            nbytes(rows, upd, out), float(nn * w),
            {"library_onehot_matmul_ms": matmul_ms, "p4_route": route})
        e = entries[-1]
        alone = set_kernel_only(e, kernel_device_ms(
            lambda: gs.scatter_add_onehot(rows, upd, t, tile_n), P4_KERNELS))
        print(f"  {tag}: route {route}: bound_ms / ms = {e['bound_ms'] / e['ms']:.3f}; "
              f"index_add_ / ms = {e['library_ms'] / e['ms']:.2f}; the route's kernels "
              f"{alone} of the call's {e['ms']:.4f} ms (the rest: the range check's aminmax "
              "and host sync, the zeroed output)")
        del rows, upd, out, upd_bf
    torch.cuda.empty_cache()
    return launches


N_CLI = 13  # optim.num_iters of the CLI run
# iterations of the resumed run before its timed window (cuBLAS, allocator),
# as phase 5 warms up before it times
CLI_WARMUP = 2
CLI_SIGTERM_AT = 5  # iteration during which SIGTERM arrives
CLI_SAVE_FREQ = 4  # logging.saveckpt_freq


def _state_diff(a, b):
    """Names of the params, moments, counts and step that differ (values
    bit for bit, moments also in dtype)."""
    bad = [] if a.step == b.step else ["step"]
    for tag, ma, mb in (("model", a.model, b.model),) + tuple(
            (f"prop{i}", x, y) for i, (x, y) in enumerate(zip(a.prop_models, b.prop_models))):
        sa, sb = ma.state_dict(), mb.state_dict()
        bad += [f"{tag}.{k}" for k in sa if not torch.equal(sa[k], sb[k])]
    for tag, oa, ob in (("opt", a.opt_state, b.opt_state),
                        ("prop_opt", a.prop_opt_state, b.prop_opt_state)):
        if oa.count != ob.count:
            bad.append(f"{tag}.count")
        bad += [f"{tag}.moment{i}" for i, (x, y) in enumerate(zip(oa.mu + oa.nu, ob.mu + ob.nu))
                if x.dtype != y.dtype or not torch.equal(x, y)]
    return bad


def phase_cli(dev, train_ms):
    """The training CLI on the full-width brick flagship: train with a
    periodic checkpoint, SIGTERM, --auto_resume, evaluate, --eval_only."""
    import logging
    import shutil
    import signal
    import tempfile

    from emernerf_torch import train_emernerf
    from emernerf_torch.flagship import _FLAGSHIP_DOTLIST, flagship_config
    from emernerf_torch.train.checkpoints import load_checkpoint
    from emernerf_torch.train.trainer import Trainer

    print("phase 8: the training CLI (python -m emernerf_torch.train_emernerf) on the full-width "
          "brick flagship")
    root = tempfile.mkdtemp(prefix="emernerf_cli_")
    run_dir = os.path.join(root, "p", "r")
    os.makedirs(run_dir)
    print(f"  run directory {run_dir}; free disk {shutil.disk_usage(root).free / 2 ** 30:.1f} GiB")
    # the CLI's log goes to the run's log.txt only (setup_logging keeps an
    # existing handler), not to this script's output
    log = logging.getLogger("emernerf_torch")
    handler = logging.FileHandler(os.path.join(run_dir, "log.txt"))
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    log.propagate = False
    opts = list(_FLAGSHIP_DOTLIST) + [
        f"optim.num_iters={N_CLI}", f"logging.saveckpt_freq={CLI_SAVE_FREQ}",
        "logging.print_freq=1000", "data.pixel_source.test_image_stride=4"]
    argv = ["--output_root", root, "--project", "p", "--run_name", "r"]
    timed = {"save_s": []}
    orig = {k: getattr(Trainer, k) for k in ("save", "train", "train_iteration")}

    def save(self):
        t0 = time.perf_counter()
        path = orig["save"](self)
        timed["save_s"].append(time.perf_counter() - t0)
        return path

    def train(self, num_iters=None):
        try:
            return orig["train"](self, num_iters)
        finally:
            torch.cuda.synchronize()
            timed["end"] = (time.perf_counter(), self.start_step)

    def train_iteration(self, step):
        if timed.get("sigterm") == step:
            os.kill(os.getpid(), signal.SIGTERM)
        if step == self.start_step + CLI_WARMUP:  # the timed window opens
            torch.cuda.synchronize()
            timed["start"] = (time.perf_counter(), len(timed["save_s"]))
        return orig["train_iteration"](self, step)

    def ckpts():
        return sorted(d for d in os.listdir(run_dir) if d.startswith("checkpoint_"))

    Trainer.save, Trainer.train, Trainer.train_iteration = save, train, train_iteration
    try:
        # 1. train with a periodic checkpoint; 2. SIGTERM during an iteration
        timed["sigterm"] = CLI_SIGTERM_AT
        t1 = train_emernerf.main(argv + opts)
        timed.pop("sigterm")
        want = [f"checkpoint_{CLI_SAVE_FREQ + 1:05d}", f"checkpoint_{CLI_SIGTERM_AT + 1:05d}"]
        print(f"  run 1: preempted={t1.preempted} at step {t1.state.step}; checkpoints {ckpts()}; "
              f"SIGTERM handler restored: {signal.getsignal(signal.SIGTERM) is signal.SIG_DFL}")
        if not t1.preempted or ckpts() != want or t1.state.step != CLI_SIGTERM_AT + 1:
            fail(f"CLI run 1: expected preemption at step {CLI_SIGTERM_AT + 1} and {want}")
        if signal.getsignal(signal.SIGTERM) is not signal.SIG_DFL:
            fail("CLI run 1: the SIGTERM handler was not restored")
        path = os.path.join(run_dir, want[1])
        size = os.path.getsize(path)
        os.remove(os.path.join(run_dir, want[0]))
        # 4. the restored state against the saved one, bit for bit
        check_trainer = Trainer(flagship_config(overrides=opts[len(_FLAGSHIP_DOTLIST):]),
                                device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_checkpoint(path, check_trainer.state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        bad = _state_diff(check_trainer.state, t1.state)
        n_tensors = len(check_trainer.state.params) + len(check_trainer.state.prop_params)
        print(f"  restored {path.rsplit('/', 1)[-1]} vs the preempted run's state: "
              f"{n_tensors} params, their moments (dtypes kept), counts and step; differ: {bad}")
        if bad:
            fail(f"restored checkpoint differs from the saved state: {bad[:10]}")
        del check_trainer, t1
        torch.cuda.empty_cache()
        # 3. --auto_resume to the end, then the end-of-training evaluation
        t2 = train_emernerf.main(argv[:6] + ["--auto_resume"] + opts)
        (t_end, start), (t_start, saves_before) = timed["end"], timed["start"]
        n_iters = N_CLI - start + 1 - CLI_WARMUP
        saves_in_run = len(timed["save_s"]) - 2  # run 1: periodic + preemption
        cli_ms = (t_end - t_start - sum(timed["save_s"][saves_before:])) * 1e3 / n_iters
        final = f"checkpoint_{N_CLI + 1:05d}"
        print(f"  run 2 (--auto_resume): from step {start} to {t2.state.step}, {saves_in_run} "
              f"checkpoints saved; checkpoints {ckpts()}")
        periodic = f"checkpoint_{(N_CLI // CLI_SAVE_FREQ) * CLI_SAVE_FREQ + 1:05d}"
        if start != CLI_SIGTERM_AT + 1 or t2.preempted or not {periodic, final} <= set(ckpts()):
            fail(f"CLI run 2: expected a resume at {CLI_SIGTERM_AT + 1}, {periodic} and {final}")
        results = _cli_metrics(run_dir, N_CLI + 1)
        # 6. --eval_only from the newest checkpoint
        t3 = train_emernerf.main(argv + ["--eval_only"] + opts)
        again = _cli_metrics(run_dir, N_CLI + 1)
        print(f"  --eval_only from {t3.cfg.resume_from.rsplit('/', 1)[-1]}: lowres/psnr "
              f"{again['lowres/psnr']!r} (end of training {results['lowres/psnr']!r})")
        if not math.isclose(again["lowres/psnr"], results["lowres/psnr"], rel_tol=1e-4):
            fail("--eval_only of the final checkpoint disagrees with the end-of-training eval")
        del t2, t3
        print(f"  CLI: {cli_ms:.2f} ms/iteration over the last {n_iters} iterations of run 2 "
              f"(after {CLI_WARMUP} warm-up ones), checkpoint saves excluded (phase 5, "
              f"Trainer.train_iteration: {train_ms:.2f} ms/iteration)")
        print(f"  checkpoint {size / 2 ** 30:.3f} GiB ({size} bytes); save "
              f"{', '.join(f'{s:.2f}' for s in timed['save_s'])} s; load {load_s:.2f} s")
    finally:
        for k, v in orig.items():
            setattr(Trainer, k, v)
        log.removeHandler(handler)
        handler.close()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return cli_ms


def _cli_metrics(run_dir, step):
    """The evaluation's metric JSONs at ``step``: lowres and test splits and
    a finite lidar depth RMSE."""
    with open(os.path.join(run_dir, f"metrics_all_{step}.json")) as f:
        results = json.load(f)
    for split in ("lowres", "test"):
        if not os.path.exists(os.path.join(run_dir, f"metrics_{split}_{step}.json")):
            fail(f"metrics_{split}_{step}.json missing")
    keys = ("lowres/psnr", "test/psnr", "lidar/depth_rmse")
    print(f"  evaluation at step {step}: {({k: results.get(k) for k in keys})}")
    if not all(np.isfinite(results.get(k, float("nan"))) for k in keys):
        fail(f"evaluation metrics missing or not finite: {results}")
    return results


N_POINTS_CLI = 3  # optim.num_iters of phase 12's training run
EVAL_SAMPLE_TOPK = 32  # render.eval_sample_topk of phase 12's --eval_only run
# render.vis_voxel_size of phase 12's --visualize_voxel run, a cut: the
# default 0.3 m over the synthetic scene's aabb is 234 x 262 x 66 = 4.05 M
# cells per timestep; 1.0 m is 70 x 78 x 20 = 109,200
VIS_VOXEL_SIZE = 1.0
POINT_CHUNK = 65536  # PointQueryEngine's chunk_size


def phase_points(dev, counted, zero):
    """Phase 12: the stock flow config (configs/default_flow.yaml,
    eval.eval_lidar_flow) through the CLI on the full-width flagship in a
    temporary run directory: N_POINTS_CLI training iterations, then the
    end-of-training evaluation (the lidar scene-flow metrics through
    PointQueryEngine, the lowres and full renders, the videos where imageio
    is installed); then --eval_only --visualize_voxel in one run (one model
    build instead of two) with render.eval_sample_topk=32 and
    render.render_novel_trajectory=true at render.vis_voxel_size=1.0 (the
    cut above); then --render_data_video_only.  Without imageio, the
    composed first frame of the full split, of the novel trajectory and of
    the data video are checked in memory.  Then the full-width
    reference-hash flagship's point queries (K4): its flow evaluation and
    the occupied voxels of one timestep.  The launch counters are zeroed
    before the first CLI run and read after the hash queries.  Returns
    (launches, K3 calls of the pruned eval by (R, S, D, C))."""
    import logging
    import shutil
    import tempfile

    from emernerf_torch import train_emernerf
    from emernerf_torch.builders import build_dataset_from_cfg
    from emernerf_torch.eval import video
    from emernerf_torch.eval.data_preview import data_video_frames
    from emernerf_torch.eval.flow import evaluate_lidar_flow
    from emernerf_torch.eval.points import PointQueryEngine
    from emernerf_torch.eval.renderer import ImageRenderer
    from emernerf_torch.eval.voxel_vis import extract_occupied_voxels
    from emernerf_torch.flagship import (
        _FLAGSHIP_DOTLIST, REFERENCE_HASH, build_flagship, flagship_config)
    from emernerf_torch.train import trainer as trainer_mod

    print("phase 12: configs/default_flow.yaml through the CLI on the full-width flagship "
          "(flow eval, videos, --eval_only --visualize_voxel with top-K renders and the novel "
          "trajectory, --render_data_video_only), then the reference-hash point queries")
    root = tempfile.mkdtemp(prefix="emernerf_points_")
    run_dir = os.path.join(root, "p", "flow")
    os.makedirs(run_dir)
    log = logging.getLogger("emernerf_torch")
    handler = logging.FileHandler(os.path.join(run_dir, "log.txt"))
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    log.propagate = False
    argv = ["--output_root", root, "--project", "p", "--run_name", "flow"]
    opts = (["--config_file", os.path.join(REPO, "configs", "default_flow.yaml")]
            + list(_FLAGSHIP_DOTLIST) + [f"optim.num_iters={N_POINTS_CLI}",
                                         "logging.print_freq=1000"])
    queries, renders, first = [], [], {}
    orig = {"flow": PointQueryEngine.query_flow, "attrs": PointQueryEngine.query_attributes,
            "split": ImageRenderer.render_split, "novel": trainer_mod.render_novel_trajectory}

    def timed_query(kind):
        def run(self, positions, *args):
            t0 = time.perf_counter()
            out = orig[kind](self, positions, *args)  # numpy: the device is done
            queries.append((kind, len(positions), time.perf_counter() - t0))
            return out
        return run

    def render_split(self, dataset, indices, downscale=1, compute_metrics=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames, metrics = orig["split"](self, dataset, indices, downscale, compute_metrics)
        secs = time.perf_counter() - t0
        renders.append((self.kw["sample_topk"], downscale, frames[0]["rgb"].size // 3
                        * len(frames), secs))
        first.setdefault(("split", self.kw["sample_topk"], downscale), frames[0])
        return frames, metrics

    def novel(renderer, dataset, **kw):
        frames = orig["novel"](renderer, dataset, **kw)
        first["novel"] = frames[0]
        return frames

    def span(fn):
        """(seconds, points) of the point queries fn() makes."""
        n0 = len(queries)
        out = fn()
        return out, sum(q[2] for q in queries[n0:]), sum(q[1] for q in queries[n0:])

    PointQueryEngine.query_flow = timed_query("flow")
    PointQueryEngine.query_attributes = timed_query("attrs")
    ImageRenderer.render_split = render_split
    trainer_mod.render_novel_trajectory = novel
    imageio = video.have_imageio()
    print(f"  imageio installed: {imageio}")
    if not imageio:
        print("  imageio is not installed on this machine: the runs write no videos; the "
              "composed first frames are checked in memory instead")
    try:
        torch.cuda.synchronize()
        for fn in counted + tuple(zero):
            fn.launches = 0
        # 1. train, then the end-of-training evaluation with the flow eval
        t_phase = t0 = time.perf_counter()
        trainer = train_emernerf.main(argv + opts)
        step = trainer.state.step
        vis_keys = ["gt_rgb", "rgb", "depth", "static_rgb", "dynamic_rgb", "dynamic_depth",
                    "forward_flow", "backward_flow"]
        del trainer
        torch.cuda.empty_cache()
        print(f"  run 1 (train {N_POINTS_CLI} iterations, evaluate): "
              f"{time.perf_counter() - t0:.1f} s")
        with open(os.path.join(run_dir, f"metrics_flow_{step}.json")) as f:
            flow = json.load(f)
        keys = {"EPE3D", "acc3d_strict", "acc3d_relax", "angle_error", "outlier"}
        print(f"  metrics_flow_{step}.json (random weights): {flow}")
        if set(flow) != keys or not all(np.isfinite(v) for v in flow.values()):
            fail(f"metrics_flow_{step}.json: expected the five finite NSFP metrics, got {flow}")
        n_flow, flow_s = sum(q[1] for q in queries if q[0] == "flow"), sum(
            q[2] for q in queries if q[0] == "flow")
        print(f"  flow eval: {n_flow} lidar points through query_flow in {flow_s:.3f} s "
              f"-> {n_flow / flow_s:.1f} points/s (host copies in)")
        # 2. --eval_only --visualize_voxel with the top-K eval and the novel path
        n0 = len(queries)
        t0 = time.perf_counter()
        tally = composite_tally(lambda: train_emernerf.main(
            argv[:6] + ["--eval_only", "--visualize_voxel"] + opts
            + [f"render.eval_sample_topk={EVAL_SAMPLE_TOPK}",
               "render.render_novel_trajectory=true", f"render.vis_voxel_size={VIS_VOXEL_SIZE}"]))
        torch.cuda.empty_cache()
        print(f"  run 2 (--eval_only --visualize_voxel): {time.perf_counter() - t0:.1f} s")
        vox = [q for q in queries[n0:] if q[0] == "attrs"]
        n_vox, vox_s = sum(q[1] for q in vox), sum(q[2] for q in vox)
        print(f"  voxel export: {n_vox} points through query_attributes in {vox_s:.3f} s "
              f"-> {n_vox / vox_s:.1f} points/s ({len(vox)} timesteps of "
              f"{vox[0][1] if vox else 0} cells at {VIS_VOXEL_SIZE} m)")
        for name in ("voxels.npz", "voxels.html", "scene_flow.npz"):
            if not os.path.getsize(os.path.join(run_dir, name)):
                fail(f"--visualize_voxel: {name} is empty")
        z = np.load(os.path.join(run_dir, "voxels.npz"))
        frames_vox = sorted(k for k in z if k.endswith("_xyz"))
        print(f"  voxels.npz: {len(frames_vox)} frames, {len(z['frame0_xyz'])} occupied cells in "
              f"frame 0; voxels.html {os.path.getsize(os.path.join(run_dir, 'voxels.html'))} "
              f"bytes; scene_flow.npz {len(np.load(os.path.join(run_dir, 'scene_flow.npz')))} "
              "arrays")
        if len(frames_vox) != len(vox) or not np.isfinite(z["frame0_xyz"]).all():
            fail("voxels.npz: one finite frame per training timestep expected")
        for (topk, ds, n, secs) in renders:
            print(f"  render_split (eval_sample_topk={topk}, downscale {ds}): {n} rays in "
                  f"{secs:.3f} s -> {n / secs:.1f} rays/s")
        exact = [n / secs for topk, ds, n, secs in renders if ds == 1 and not topk]
        pruned = [n / secs for topk, ds, n, secs in renders if ds == 1 and topk]
        print(f"  full split: top-{EVAL_SAMPLE_TOPK} eval {pruned[0]:.1f} rays/s beside the exact "
              f"render's {exact[0]:.1f} rays/s")
        for key, frame in first.items():
            for k, v in frame.items():
                if not np.isfinite(v).all():
                    fail(f"{key}: map {k} is not finite")
        # 3. --render_data_video_only
        t0 = time.perf_counter()
        if train_emernerf.main(argv[:6] + ["--render_data_video_only"] + opts) is not None:
            fail("--render_data_video_only built a model")
        print(f"  run 3 (--render_data_video_only): {time.perf_counter() - t0:.1f} s")
        data = [f for f in os.listdir(run_dir) if f.startswith("data.")]
        videos = sorted(os.listdir(os.path.join(run_dir, "videos")))
        print(f"  videos: {videos}; data video: {data}")
        if imageio:
            want = {f"{n}_{step}" for n in ("lowres", "full", "novel")}
            if not want <= {os.path.splitext(v)[0] for v in videos} or not data:
                fail(f"videos missing: expected {sorted(want)} and data.*")
        else:
            if videos or data:
                fail("videos written without imageio")
            h, w = first[("split", 0, 1)]["rgb"].shape[:2]
            # the flagship's scene, as the flow config's (which changes no data key)
            frames, keys = data_video_frames(build_dataset_from_cfg(flagship_config()))
            for what, frame, ks, rows, hw in (
                    ("full split", first[("split", 0, 1)], vis_keys, len(vis_keys), (h, w)),
                    ("novel trajectory", first["novel"], ["rgb", "depth"], 2, None),
                    ("data video", frames[0], keys, len(keys), (h, w))):
                img = video.compose_frame(frame, ks)
                fh, fw = hw or frame["rgb"].shape[:2]
                print(f"  composed first frame of the {what}: {img.dtype} {img.shape}")
                if img.dtype != np.uint8 or img.shape != (rows * fh, fw, 3):
                    fail(f"composed {what} frame: {img.dtype} {img.shape}, expected uint8 "
                         f"{(rows * fh, fw, 3)}")
        # 4. the reference-hash flagship's point queries (K4)
        _, dataset, model, props, _ = build_flagship(profile=REFERENCE_HASH, device=dev, seed=0)
        engine = PointQueryEngine(model, device=dev)
        hash_flow, secs, n = span(lambda: evaluate_lidar_flow(engine, dataset))
        print(f"  reference-hash flow eval: {n} points in {secs:.3f} s -> {n / secs:.1f} "
              f"points/s; metrics {hash_flow}")
        t = float(dataset.unique_normalized_training_timestamps[0])
        (coords, _), secs, n = span(lambda: extract_occupied_voxels(
            engine, dataset.aabb, VIS_VOXEL_SIZE, t))
        print(f"  reference-hash voxels at t={t:.4f}: {n} cells in {secs:.3f} s -> "
              f"{n / secs:.1f} points/s, {len(coords)} occupied")
        if not all(np.isfinite(v) for v in hash_flow.values()) or not np.isfinite(coords).all():
            fail("reference-hash point queries: non-finite results")
        del model, props, engine
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted + tuple(zero)}
        print(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s; launch counts: {launches}")
        _check_launches(launches, {fn.__name__ for fn in zero}, "points run")
        pruned_tally = {k: v for k, v in tally.items() if k[2] == 3}
        print(f"  K3 forward calls of the top-{EVAL_SAMPLE_TOPK} eval with three density sets "
              f"by (R, S, D, C): {pruned_tally}")
    finally:
        PointQueryEngine.query_flow, PointQueryEngine.query_attributes = orig["flow"], orig["attrs"]
        ImageRenderer.render_split = orig["split"]
        trainer_mod.render_novel_trajectory = orig["novel"]
        log.removeHandler(handler)
        handler.close()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return launches, pruned_tally


def point_batches(dev, g, n=POINT_CHUNK, voxel_size=VIS_VOXEL_SIZE):
    """The contracted grid queries of phase 12's point paths on the
    flagship scene: the first chunk of the voxel grid (N, 3), the same at a
    training timestamp (N, 4), the warped 2N batch of query_attributes'
    aggregation (each point moved by up to 0.5 m and one frame of 8 in
    time, both ways), and the flow eval's scored lidar returns of frame 0
    (M, 4)."""
    from emernerf_torch.builders import build_dataset_from_cfg
    from emernerf_torch.eval.flow import flow_eval_points
    from emernerf_torch.eval.voxel_vis import voxel_grid
    from emernerf_torch.flagship import flagship_config
    from emernerf_torch.models.fields import _contract

    dataset = build_dataset_from_cfg(flagship_config())
    aabb = torch.tensor(dataset.aabb, device=dev)

    def contract(world):
        return _contract(world, aabb, True)

    world = torch.from_numpy(voxel_grid(dataset.aabb, voxel_size)[:n].astype(np.float32)).to(dev)
    ts = dataset.unique_normalized_training_timestamps
    t = float(ts[len(ts) // 2])
    times = torch.full((len(world), 1), t, device=dev)
    shift = torch.rand(world.shape, device=dev, generator=g) - 0.5
    warped = torch.cat([torch.cat([contract(world + shift), (times + 1 / 8).clamp(0, 1)], -1),
                        torch.cat([contract(world - shift), (times - 1 / 8).clamp(0, 1)], -1)])
    pts, lidar_t, _ = flow_eval_points(dataset, 0)
    lidar = torch.cat([contract(torch.from_numpy(pts).to(dev)),
                       torch.from_numpy(lidar_t).to(dev)[:, None]], -1)
    xyz = contract(world)
    return {"voxels": xyz.contiguous(), "voxels_t": torch.cat([xyz, times], -1).contiguous(),
            "voxels_warped": warped.contiguous(), "lidar": lidar.contiguous()}


def phase_points_kernels(dev, entries, after_timed, pruned_tally):
    """Phase 12b: the grid and compositing kernels at phase 12's new shapes
    against their plain versions, reported under the path "points": K1
    forward on the flagship's static grid at one 65,536-point chunk of the
    voxel grid and on its fused dynamic+flow grid at that chunk at a
    training timestamp, at the warped 2N batch and at the flow eval's lidar
    returns (fp32 tables, fp32 and the flagship's bf16 computation, bit for
    bit); K4 forward at the same chunk on the reference-hash static,
    dynamic and flow grids (fp32 bit for bit; bf16, one rounding, rtol
    2^-7); K3 forward at the shape of the top-K eval's final composite,
    on inputs zero but at the shaded samples."""
    from emernerf_torch.ops.brickgrid import brickgrid_encode, brickgrid_encode_ref
    from emernerf_torch.ops.hashgrid import hashgrid_encode, hashgrid_encode_plain

    print("phase 12b: K1, K4 and K3 forward vs plain versions at the point-query and top-K "
          "eval shapes")
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(12)
    pts = point_batches(dev, g)
    specs, hspecs = flagship_specs(), hash_specs()
    with torch.no_grad():
        for name, batch in (("static", "voxels"), ("dynflow", "voxels_t"),
                            ("dynflow", "voxels_warped"), ("dynflow", "lidar")):
            spec, pos = specs[name], pts[batch]
            table = torch.rand(spec.table_shape, device=dev, generator=g) * 2 - 1
            touched = brick_touched(spec, pos)
            for label, compute in (("fp32", torch.float32), ("fp32->bf16", torch.bfloat16)):
                out = brickgrid_encode(table, pos, spec, compute)
                ref = brickgrid_encode_ref(table, pos, spec, compute)
                tag = f"brickgrid_encode[{name},{batch},{label},N={pos.shape[0]}]"
                exact = torch.equal(out, ref)
                print(f"  {tag}: bit for bit with the plain version: {exact} (tolerance 0)")
                if not exact:
                    fail(f"{tag}: kernel and plain version differ")
                ms = cuda_ms(lambda: brickgrid_encode(table, pos, spec, compute), 10)
                plain_ms = cuda_ms(lambda: brickgrid_encode_ref(table, pos, spec, compute), 3)
                add_entry(entries, tag, "brickgrid.cu", "emernerf_tpu/ops/brickgrid.py:581",
                          brickgrid_encode, 0.0, ms, plain_ms,
                          nbytes(pos, out) + touched * table.element_size(),
                          grid_ops(spec, pos.shape[0], False, False), path="points")
                del out, ref
            del table
        for name, batch in (("static", "voxels"), ("dynamic", "voxels_t"), ("flow", "voxels_t")):
            spec, pos = hspecs[name], pts[batch]
            table32 = torch.rand(spec.table_shape, device=dev, generator=g) * 2 - 1
            touched = hash_touched(spec, pos)
            for dtype, rtol in ((torch.float32, 0.0), (torch.bfloat16, 2 ** -7)):
                table = table32.to(dtype)
                out = hashgrid_encode(table, pos, spec)
                ref = hashgrid_encode_plain(table, pos, spec)
                tag = f"hashgrid_encode[{name},{batch},{str(dtype)[6:]},N={pos.shape[0]}]"
                mx, over = compare(tag, out.float(), ref.float(), rtol, 0.0 if rtol == 0 else 1e-6)
                if over:
                    fail(f"{tag}: {over} elements over tolerance")
                ms = cuda_ms(lambda: hashgrid_encode(table, pos, spec), 10)
                plain_ms = cuda_ms(lambda: hashgrid_encode_plain(table, pos, spec), 3)
                add_entry(entries, tag, "hashgrid.cu", "emernerf_tpu/ops/hashgrid.py:408",
                          hashgrid_encode, mx, ms, plain_ms,
                          nbytes(pos, out) + touched * table.element_size(),
                          grid_ops(spec, pos.shape[0], False, False), path="points")
                del out, ref, table
            del table32
    del pts
    torch.cuda.empty_cache()
    for r, s_, d, c in sorted(pruned_tally):
        sets = EVAL_SETS if c == len(EVAL_SETS) else [j % d for j in range(c)]
        composite_row(dev, 12, entries, after_timed, r, s_, d, sets, 100.0, path="points",
                      grad=False, keep=EVAL_SAMPLE_TOPK)
    torch.cuda.empty_cache()
    print(f"  phase 12b took {time.perf_counter() - t0:.1f} s")


# phase 13's Waymo-layout scene (data/waymo.py's layout) and its cuts
WAYMO_FRAMES = 20  # cut from a NOTR scene's ~200 frames
WAYMO_CAMS = 3  # data.pixel_source.num_cams: CAMERA_LISTS[3], the three front cameras
WAYMO_LIDAR = 160_000  # top-lidar returns per frame
WAYMO_FEAT = (91, 137, 768)  # dinov2_vitb14's map at stride 7 on 644x966, stored fp16
WAYMO_OCC_VOXEL = 0.4  # data.occ_source.voxel_size, cut from 0.1 to keep the files small
WAYMO_OCC_VOXELS = 4000  # annotated voxels per frame


def write_waymo_scene(root, n_frames=WAYMO_FRAMES, num_cams=WAYMO_CAMS, n_lidar=WAYMO_LIDAR,
                      feat_shape=WAYMO_FEAT, image_hw=None, occ_voxels=WAYMO_OCC_VOXELS,
                      feature_model="dinov2_vitb14", seed=0):
    """Writes scene 000 of a preprocessed Waymo scene under ``root``, made
    from ``seed``: the ego drives 1 m per frame along x; the cameras of
    CAMERA_LISTS[num_cams] 1.5 m ahead of it, turned by 45 degrees per
    place from the front, their JPEGs (smooth random colour) at the
    camera's original size (or ``image_hw``), sky masks (the top fifth),
    dynamic masks (a box that moves); ``n_lidar`` top-lidar returns per
    frame (ground plane and a wall band within 75 m, a quarter of them on
    a moving vehicle: velocity 5 m/s, flow class 1); fp16 feature maps of
    ``feat_shape`` (rank 96 plus a per-pixel ramp); Occ3D annotations at
    0.4 m (``occ_voxels`` labelled voxels of the front half, labels 0-14)."""
    from PIL import Image

    from emernerf_torch.data.waymo import CAMERA_LISTS, ORIGINAL_SIZE

    rng = np.random.default_rng(seed)
    scene = os.path.join(root, "000")
    for sub in ("images", "intrinsics", "extrinsics", "ego_pose", "lidar", "sky_masks",
                "dynamic_masks", "occ3d", feature_model):
        os.makedirs(os.path.join(scene, sub), exist_ok=True)
    cams = CAMERA_LISTS[num_cams]
    yaw = {0: 0.0, 1: 45.0, 2: -45.0, 3: 90.0, 4: -90.0}
    for cam in cams:
        oh, ow = ORIGINAL_SIZE[cam]
        np.savetxt(os.path.join(scene, "intrinsics", f"{cam}.txt"),
                   np.array([0.8 * ow, 0.8 * ow, ow / 2.0, oh / 2.0, 0, 0, 0, 0, 0]))
        a = np.deg2rad(yaw[cam])
        c2e = np.eye(4)
        c2e[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        c2e[:3, 3] = [1.5, 0.0, 2.0]
        np.savetxt(os.path.join(scene, "extrinsics", f"{cam}.txt"), c2e)
    hf, wf, cf = feat_shape
    basis = rng.standard_normal((96, cf)).astype(np.float32)
    ramp = np.linspace(-1.0, 1.0, hf * wf, dtype=np.float32)[:, None]
    for t in range(n_frames):
        ego = np.eye(4)
        ego[0, 3] = 100.0 + t
        np.savetxt(os.path.join(scene, "ego_pose", f"{t:03d}.txt"), ego)
        for cam in cams:
            oh, ow = image_hw or ORIGINAL_SIZE[cam]
            small = (rng.uniform(0, 255, (max(oh // 32, 2), max(ow // 32, 2), 3))).astype(np.uint8)
            Image.fromarray(small).resize((ow, oh), Image.BILINEAR).save(
                os.path.join(scene, "images", f"{t:03d}_{cam}.jpg"), quality=90)
            sky = np.zeros((oh, ow), np.uint8)
            sky[: oh // 5] = 255
            Image.fromarray(sky).save(os.path.join(scene, "sky_masks", f"{t:03d}_{cam}.png"))
            dyn = np.zeros((oh, ow), np.uint8)
            x0 = (t * ow // (2 * n_frames)) % max(ow - ow // 8, 1)
            dyn[oh // 2: oh // 2 + oh // 8, x0: x0 + ow // 8] = 255
            Image.fromarray(dyn).save(os.path.join(scene, "dynamic_masks", f"{t:03d}_{cam}.png"))
            latent = rng.standard_normal((hf * wf, 96)).astype(np.float32)
            feat = (latent @ basis + 4.0 * ramp * basis[0]).reshape(hf, wf, cf)
            np.save(os.path.join(scene, feature_model, f"{t:03d}_{cam}.npy"),
                    feat.astype(np.float16))
        # lidar: N x 14 (origin 3, point 3, velocity 3, flow class, ground,
        # intensity, elongation, laser id), in the ego frame
        info = np.zeros((n_lidar, 14), np.float32)
        info[:, 2] = 2.0
        az = rng.uniform(-np.pi, np.pi, n_lidar)
        el = rng.uniform(np.deg2rad(-17.0), np.deg2rad(2.0), n_lidar)
        d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1)
        rng_ground = np.where(d[:, 2] < -1e-3, 2.0 / np.maximum(-d[:, 2], 1e-3), np.inf)
        ranges = np.minimum(rng_ground, rng.uniform(20.0, 75.0, n_lidar))
        info[:, 3:6] = info[:, :3] + d * ranges[:, None]
        moving = rng.random(n_lidar) < 0.25
        info[moving, 6] = 5.0
        info[moving, 9] = 1
        info[:, 10] = info[:, 5] < 0.05
        info[:, 11] = rng.random(n_lidar)
        info.tofile(os.path.join(scene, "lidar", f"{t:03d}.bin"))
        # Occ3D at 0.4 m: (200, 200, 16), 23 = free; the loader keeps x >= 100
        label = np.full((200, 200, 16), 23, np.uint8)
        label[rng.integers(100, 200, occ_voxels), rng.integers(0, 200, occ_voxels),
              rng.integers(0, 16, occ_voxels)] = rng.integers(0, 15, occ_voxels)
        np.savez(os.path.join(scene, "occ3d", f"{t:03d}_04.npz"), voxel_label=label,
                 final_voxel_state=np.ones((200, 200, 16), np.uint8))
    return scene


N_WAYMO_CLI = 4  # optim.num_iters of phase 13's CLI run
N_WAYMO_TIMED = 6  # iterations timed after it, on the trainer the CLI returns


def waymo_dotlist(root):
    """Phase 13's settings: the flagship's branches (dynamic, flow, shadow)
    on the stock defaults, the Waymo loader on ``root`` at the default load
    size, the feature head with the learnable PE map (the defaults'
    widths), the occupancy eval at 0.4 m and the deletion of the feature
    maps after the run; render.render_full=false is a cut (the lowres
    split of every image, not full-size renders)."""
    from emernerf_torch.flagship import _FLAGSHIP_DOTLIST

    return list(_FLAGSHIP_DOTLIST) + [
        f"data.data_root={root}", "data.dataset=waymo", "data.scene_idx=0",
        f"data.pixel_source.num_cams={WAYMO_CAMS}", "data.pixel_source.load_features=true",
        "data.pixel_source.skip_feature_extraction=true",
        "nerf.model.head.enable_feature_head=true",
        f"data.occ_source.voxel_size={WAYMO_OCC_VOXEL}", "eval.eval_occ=true",
        "render.render_full=false", "data.pixel_source.delete_features_after_run=true"]


def phase_waymo(dev, counted, zero, train_ms, busy5, peak5):
    """Phase 13: the feature head on a Waymo-layout scene through the CLI.
    Writes the scene (write_waymo_scene) to a temporary directory, trains
    N_WAYMO_CLI iterations of the full-width flagship with the feature
    head, evaluates (the lowres split with feat_psnr, the occupancy eval,
    the feature video where imageio is installed, else the composed first
    frame in memory), deletes the feature maps; then on the trainer the
    CLI returns: N_WAYMO_TIMED timed iterations (ms/iteration, peak
    memory), a profile of 2 (device busy, top items beside phase 5's) and
    one more iteration's K3 calls.  The launch counters are zeroed before
    the CLI run and read after the profiled iterations.  Then the control:
    the same scene and flagship without the feature head, timed and
    profiled the same way.  Returns (launches, K3 calls of training, K3
    calls of the eval, ms/iteration, busy, peak GiB, eval peak GiB, and
    the control's ms/iteration and busy)."""
    import logging
    import shutil
    import tempfile

    from emernerf_torch import train_emernerf
    from emernerf_torch.config import load_config
    from emernerf_torch.eval import video
    from emernerf_torch.eval.renderer import ImageRenderer
    from emernerf_torch.flagship import DEFAULT_CONFIG
    from emernerf_torch.train.trainer import Trainer

    print("phase 13: the feature head (DINO lifting, learnable PE, feature loss, feature PSNR, "
          "occupancy eval) on a Waymo-layout scene through the CLI, full-width flagship")
    root = tempfile.mkdtemp(prefix="emernerf_waymo_")
    t_phase = t0 = time.perf_counter()
    scene = write_waymo_scene(root)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(scene) for f in fs)
    print(f"  wrote the scene in {time.perf_counter() - t0:.1f} s ({size / 2 ** 30:.2f} GiB): "
          f"{WAYMO_CAMS} cameras (CAMERA_LISTS[{WAYMO_CAMS}], JPEGs at each camera's original "
          f"size), sky and dynamic masks, {WAYMO_LIDAR} top-lidar returns per frame, fp16 "
          f"feature maps {WAYMO_FEAT} per image, Occ3D files at {WAYMO_OCC_VOXEL} m")
    print(f"  cuts: {WAYMO_FRAMES} frames (a NOTR scene has ~200); Occ3D at {WAYMO_OCC_VOXEL} m "
          f"(from 0.1 m); render.render_full=false (the eval renders the lowres split); "
          f"{N_WAYMO_CLI} + {N_WAYMO_TIMED} + 3 training iterations")
    run_dir = os.path.join(root, "p", "waymo")
    os.makedirs(run_dir)
    log = logging.getLogger("emernerf_torch")
    handler = logging.FileHandler(os.path.join(run_dir, "log.txt"))
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    log.propagate = False
    argv = (["--output_root", root, "--project", "p", "--run_name", "waymo"]
            + waymo_dotlist(root) + [f"optim.num_iters={N_WAYMO_CLI}", "logging.print_freq=1"])
    orig = {"split": ImageRenderer.render_split, "evaluate": Trainer.evaluate}
    first, eval_peak = {}, []

    def render_split(self, dataset, indices, downscale=1, compute_metrics=True):
        frames, metrics = orig["split"](self, dataset, indices, downscale, compute_metrics)
        first.setdefault(downscale, frames[0])
        return frames, metrics

    def evaluate(self):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = orig["evaluate"](self)
        eval_peak.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        return out

    ImageRenderer.render_split, Trainer.evaluate = render_split, evaluate
    trainer = None
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.synchronize()
        for fn in counted + tuple(zero):
            fn.launches = 0
        t0 = time.perf_counter()
        holder = []
        tally_cli = composite_tally(lambda: holder.append(train_emernerf.main(argv)))
        trainer = holder.pop()
        step = trainer.state.step
        print(f"  CLI run (load the scene, build, train {N_WAYMO_CLI} iterations, evaluate, "
              f"delete the features): {time.perf_counter() - t0:.1f} s; eval peak device "
              f"memory {eval_peak[0]:.2f} GiB")
        ds = trainer.dataset
        print(f"  dataset: {ds.num_images} images of {ds.image_hw}, features "
              f"{tuple(ds.features.shape)} (PCA of {WAYMO_FEAT[-1]}), "
              f"{len(ds.lidar['ranges'])} lidar rays; model "
              f"{sum(p.numel() for p in trainer.state.params)} params, PE map "
              f"{tuple(trainer.model.learnable_pe_map.shape)}")
        with open(os.path.join(run_dir, "metrics.json")) as f:
            records = [json.loads(x) for x in f.read().splitlines()]
        losses = {k: records[-1][k] for k in ("rgb_loss", "feature_loss", "cycle_loss")}
        print(f"  losses at the last print: {losses}")
        with open(os.path.join(run_dir, f"metrics_all_{step}.json")) as f:
            results = json.load(f)
        with open(os.path.join(run_dir, f"metrics_occ_{step}.json")) as f:
            occ = json.load(f)
        keys = ("lowres/psnr", "lowres/feat_psnr", "lowres/masked_feat_psnr",
                "occ/micro_accuracy", "occ/cover_rate", "lidar/depth_rmse")
        print(f"  evaluation (random weights): {({k: results.get(k) for k in keys})}; occupancy "
              f"{occ['num_measured_points']} of {occ['num_total_points']} voxels measured")
        if not all(np.isfinite(results.get(k, float("nan"))) for k in keys) or not all(
                np.isfinite(v) for v in losses.values()):
            fail(f"phase 13: losses or evaluation metrics missing or not finite: {results}")
        if occ["num_total_points"] <= 0:
            fail("phase 13: the occupancy eval read no annotated voxels")
        left = [f for f in os.listdir(os.path.join(scene, "dinov2_vitb14"))
                if f.endswith(".npy")]
        print(f"  feature maps left after delete_features_after_run: {len(left)}")
        if left:
            fail("phase 13: delete_features_after_run left feature maps")
        frame = first[trainer.cfg.render.low_res_downscale]
        vis = ["gt_rgb", "rgb", "depth", "static_rgb", "dynamic_rgb", "dynamic_depth",
               "forward_flow", "backward_flow", "dino_feat"]
        videos = sorted(os.listdir(os.path.join(run_dir, "videos")))
        if video.have_imageio():
            print(f"  videos: {videos}")
            if f"lowres_{step}" not in {os.path.splitext(v)[0] for v in videos}:
                fail("phase 13: the lowres video (with dino_feat) is missing")
        else:
            img = video.compose_frame(frame, vis)
            h, w = frame["rgb"].shape[:2]
            print(f"  imageio is not installed: the composed first lowres frame with the "
                  f"feature map: {img.dtype} {img.shape}")
            if img.dtype != np.uint8 or img.shape != (len(vis) * h, w, 3):
                fail(f"phase 13: composed frame {img.dtype} {img.shape}")
        for k, v in frame.items():
            if not np.isfinite(v).all():
                fail(f"phase 13: lowres map {k} is not finite")
        print(f"  lowres maps: {sorted(frame)}")

        # the timed window on the CLI's trainer
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(N_WAYMO_TIMED):
            trainer.train_iteration(step + i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / N_WAYMO_TIMED
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rows, busy = profile_train(trainer, step + N_WAYMO_TIMED, ms, "profile_train_waymo.json")
        share = profile_shares(rows, busy)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted + tuple(zero)}
        tally = composite_tally(lambda: trainer.train_iteration(step + N_WAYMO_TIMED + 2))
        rays = 2 * trainer.ray_batch_size
        print(f"  {ms:.2f} ms/iteration ({N_WAYMO_TIMED} iterations), {rays / ms * 1e3:.1f} "
              f"rays/s, device busy {busy:.2f} ms per iteration, peak device memory "
              f"{peak:.2f} GiB; phase 5 (no feature head, synthetic scene): {train_ms:.2f} "
              f"ms/iteration, busy {busy5:.2f} ms, peak {peak5:.2f} GiB")
        for what, keys in PROFILE_SHARES:
            print(f"  {what}: {share[what]:.1%} of the device time")
        print(f"  launch counts (CLI run and timed iterations): {launches}")
        _check_launches(launches, {fn.__name__ for fn in zero}, "feature-head run")
        eval_tally = {k: v for k, v in tally_cli.items() if k[2] == 3}
        print(f"  K3 forward calls by (R, S, D, C): one training iteration {tally}; the "
              f"eval's with three density sets {eval_tally}")
        # shadow_ratio^2 and rgb, then dino_feat; the eval's 23 channels of
        # the decomposition, then dino_feat, static_dino and dynamic_dino
        fe = trainer.model.dino_head.layers[-1].out_features
        if not any(c == 4 + fe for (_, _, _, c) in tally) or not any(
                c == 23 + 3 * fe for (_, _, _, c) in eval_tally):
            fail(f"phase 13: expected K3 at C = {4 + fe} in training and C = {23 + 3 * fe} in "
                 "the eval")
        # the control: the same scene and flagship without the feature head
        del trainer
        trainer = None
        torch.cuda.empty_cache()
        off = ["nerf.model.head.enable_feature_head=false",
               "data.pixel_source.load_features=false", "eval.eval_occ=false"]
        trainer = Trainer(load_config(DEFAULT_CONFIG, None, waymo_dotlist(root) + off),
                          device=dev)
        for i in range(3):  # warm-up: cuBLAS, allocator
            trainer.train_iteration(i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(3, 3 + N_WAYMO_TIMED):
            trainer.train_iteration(i)
        torch.cuda.synchronize()
        ms_off = (time.perf_counter() - t0) * 1e3 / N_WAYMO_TIMED
        peak_off = torch.cuda.max_memory_allocated() / 2 ** 30
        print("  control: the same scene without the feature head")
        _, busy_off = profile_train(trainer, 3 + N_WAYMO_TIMED, ms_off,
                                    "profile_train_waymo_no_features.json")
        print(f"  control: {ms_off:.2f} ms/iteration, device busy {busy_off:.2f} ms, peak "
              f"{peak_off:.2f} GiB; with the feature head {ms:.2f}, {busy:.2f}, {peak:.2f}")
        print(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s")
        return launches, tally, eval_tally, ms, busy, peak, eval_peak[0], ms_off, busy_off
    finally:
        ImageRenderer.render_split, Trainer.evaluate = orig["split"], orig["evaluate"]
        log.removeHandler(handler)
        handler.close()
        del trainer
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def phase_waymo_kernels(dev, entries, after_timed, tally, eval_tally):
    """Phase 13b: K3 forward at the feature head's shapes of phase 13 (the
    training composite at C = 68 with a gradient, the eval's at C = 215
    under no_grad) and K3 backward at the training call (C = 68, every
    cotangent) against their plain versions."""
    from emernerf_torch.render.volrend import composite_along_rays_bwd, composite_along_rays_bwd_ref

    print("phase 13b: K3 forward and backward vs plain versions at the feature head's shapes")
    t0 = time.perf_counter()
    shapes = sorted({k for k in tally if k[3] > 64}) + sorted(
        {k for k in eval_tally if k[3] > 64})
    for i, (r, s_, d, c) in enumerate(shapes):
        grad = (r, s_, d, c) in tally
        composite_row(dev, 60 + i, entries, after_timed, r, s_, d, [j % d for j in range(c)],
                      80.0, path="waymo", grad=grad)
    n_ch = max(k[3] for k in tally)
    args = composite_bwd_inputs(dev, 70, NUM_SAMPLES, True, n_ch)
    out = composite_along_rays_bwd(*args)
    ref = composite_along_rays_bwd_ref(*args)
    tag = f"composite_along_rays_bwd[R={N_TRAIN},S={NUM_SAMPLES},D=1,C={n_ch},w/opacity/depth/sums]"
    mx = max(check(tag + ".d_dens", out[0], ref[0], 1e-4, 1e-5),
             check(tag + ".d_vals", out[1], ref[1], 1e-4, 1e-5))
    ms = cuda_ms(lambda: composite_along_rays_bwd(*args), 20)
    plain_ms = cuda_ms(lambda: composite_along_rays_bwd_ref(*args), 5)
    add_entry(entries, tag, "composite.cu", "emernerf_tpu/render/volrend.py:33",
              composite_along_rays_bwd, mx, ms, plain_ms, nbytes(*args[:4], *args[5], *out),
              3 * N_TRAIN * NUM_SAMPLES * (12 + 2 * n_ch), path="waymo")
    after_timed.append((entries[-1], K3_BACKWARD_KERNELS,
                        remade(lambda: composite_bwd_inputs(dev, 70, NUM_SAMPLES, True, n_ch),
                               composite_along_rays_bwd), True))
    del args, out, ref
    torch.cuda.empty_cache()
    print(f"  phase 13b took {time.perf_counter() - t0:.1f} s")


# phase 14's nuScenes scene (the devkit's table layout) and its cuts
NUSC_FRAMES = 40  # per camera, cut from a 20 s scene's ~240 at 12 Hz
NUSC_HW = (900, 1600)  # the cameras' size on disk
NUSC_LIDAR = 34_700  # LIDAR_TOP returns per sweep
NUSC_CAM_US = 83_333  # 12 Hz camera shutters
NUSC_LIDAR_US = 50_000  # 20 Hz lidar sweeps
# camera yaws from the ego's x axis, degrees, in CAMERA_LISTS[6]'s order
NUSC_YAW = (55.0, 0.0, -55.0, 110.0, 180.0, -110.0)


def _token(*parts) -> str:
    """A 32-hex token, as the tables use."""
    import hashlib

    return hashlib.md5("/".join(map(str, parts)).encode()).hexdigest()


def _qmul(a, b):
    """Hamilton product of [w, x, y, z] quaternions."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return [aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw]


def write_nuscenes_scene(root, n_frames=NUSC_FRAMES, image_hw=NUSC_HW, n_lidar=NUSC_LIDAR,
                         feat_shape=None, version="v1.0-trainval", seed=0):
    """Writes one nuScenes scene under ``root`` in the devkit's layout, made
    from ``seed``: the tables ``{root}/{version}/{scene,sample,sample_data,
    calibrated_sensor,ego_pose,sensor}.json`` (the documented schema: 32-hex
    tokens, microsecond timestamps, [w, x, y, z] rotations, sample records
    without ``data``); the six cameras of CAMERA_LISTS[6] on 12 Hz chains
    of JPEGs (smooth random colour) at ``image_hw``, their shutters offset
    by a sixth of a period each and their chains n_frames, n_frames + 1 and
    n_frames + 2 long in turn, each image with the ego pose at its own
    timestamp; sky masks (the top fifth) under samples_sky_mask and
    sweeps_sky_mask; a 20 Hz LIDAR_TOP chain over the same span of
    ``.pcd.bin`` sweeps of ``n_lidar`` returns (x, y, z, intensity, ring as
    float32; a ground plane and a band of walls within 70 m); key frames
    every 6th image and 10th sweep under samples/, the rest under sweeps/;
    and, with ``feat_shape``, fp16 feature maps beside the images
    (samples_dinov2_vitb14).  The ego drives 10 m/s along x.  Returns root."""
    from PIL import Image

    from emernerf_torch.data.nuscenes import ALL_CAMERAS, _feature_path, _sky_mask_path

    rng = np.random.default_rng(seed)
    h, w = image_hw
    t0 = 1_532_402_927_612_460
    speed = 10.0  # m/s
    sensors, calibs, egos, sds = [], [], [], []
    key_samples = {}

    def ego_at(ts):
        tok = _token("ego", len(egos), ts)
        egos.append({"token": tok, "timestamp": ts, "rotation": [1.0, 0.0, 0.0, 0.0],
                     "translation": [speed * (ts - t0) * 1e-6, 0.0, 0.0]})
        return tok

    def chain(channel, stamps, key_every, files):
        toks = [_token("sd", channel, i) for i in range(len(stamps))]
        for i, ts in enumerate(stamps):
            key = i % key_every == 0
            if key:
                key_samples.setdefault(i // key_every, ts)
            sds.append({"token": toks[i], "sample_token": _token("sample", i // key_every),
                        "ego_pose_token": ego_at(ts),
                        "calibrated_sensor_token": _token("calib", channel), "timestamp": ts,
                        "fileformat": "jpg" if channel != "LIDAR_TOP" else "pcd",
                        "is_key_frame": key,
                        "height": h if channel != "LIDAR_TOP" else 0,
                        "width": w if channel != "LIDAR_TOP" else 0,
                        "filename": files(i, key, ts),
                        "prev": toks[i - 1] if i else "",
                        "next": toks[i + 1] if i + 1 < len(stamps) else ""})

    cam_files = []
    for c, cam in enumerate(ALL_CAMERAS):
        sensors.append({"token": _token("sensor", cam), "channel": cam, "modality": "camera"})
        a = np.deg2rad(NUSC_YAW[c])
        # OpenCV camera axes (z forward) into the ego frame (x forward), then the yaw
        rot = _qmul([np.cos(a / 2), 0.0, 0.0, np.sin(a / 2)], [0.5, -0.5, 0.5, -0.5])
        calibs.append({"token": _token("calib", cam), "sensor_token": _token("sensor", cam),
                       "translation": [1.5 * np.cos(a), 0.5 * np.sin(a), 1.5],
                       "rotation": [float(v) for v in rot],
                       "camera_intrinsic": [[0.79 * w, 0.0, w / 2.0], [0.0, 0.79 * w, h / 2.0],
                                            [0.0, 0.0, 1.0]]})
        stamps = [t0 + c * NUSC_CAM_US // 6 + k * NUSC_CAM_US for k in range(n_frames + c % 3)]

        def files(i, key, ts, cam=cam):
            name = f"{'samples' if key else 'sweeps'}/{cam}/n000__{cam}__{ts}.jpg"
            cam_files.append(name)
            return name

        chain(cam, stamps, 6, files)
    lidar_files = []
    sensors.append({"token": _token("sensor", "LIDAR_TOP"), "channel": "LIDAR_TOP",
                    "modality": "lidar"})
    calibs.append({"token": _token("calib", "LIDAR_TOP"),
                   "sensor_token": _token("sensor", "LIDAR_TOP"),
                   "translation": [0.94, 0.0, 1.84], "rotation": [1.0, 0.0, 0.0, 0.0],
                   "camera_intrinsic": []})
    span = (n_frames + 2) * NUSC_CAM_US
    n_sweeps = span // NUSC_LIDAR_US + 1

    def lidar_name(i, key, ts):
        name = f"{'samples' if key else 'sweeps'}/LIDAR_TOP/n000__LIDAR_TOP__{ts}.pcd.bin"
        lidar_files.append(name)
        return name

    chain("LIDAR_TOP", [t0 + i * NUSC_LIDAR_US for i in range(n_sweeps)], 10, lidar_name)

    n_samples = max(key_samples) + 1
    samples = [{"token": _token("sample", i), "timestamp": key_samples[i],
                "prev": _token("sample", i - 1) if i else "",
                "next": _token("sample", i + 1) if i + 1 < n_samples else "",
                "scene_token": _token("scene", 0)} for i in range(n_samples)]
    scene = [{"token": _token("scene", 0), "log_token": _token("log", 0),
              "nbr_samples": n_samples, "first_sample_token": samples[0]["token"],
              "last_sample_token": samples[-1]["token"], "name": "scene-0001",
              "description": "synthetic, written from a seed"}]
    os.makedirs(os.path.join(root, version), exist_ok=True)
    for name, records in (("scene", scene), ("sample", samples), ("sample_data", sds),
                          ("calibrated_sensor", calibs), ("ego_pose", egos),
                          ("sensor", sensors)):
        with open(os.path.join(root, version, f"{name}.json"), "w") as f:
            json.dump(records, f)

    sky = np.zeros((h, w), np.uint8)
    sky[: h // 5] = 255
    sky_img = Image.fromarray(sky)
    for name in cam_files:
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        small = rng.uniform(0, 255, (max(h // 32, 2), max(w // 32, 2), 3)).astype(np.uint8)
        Image.fromarray(small).resize((w, h), Image.BILINEAR).save(path, quality=90)
        mask = os.path.join(root, _sky_mask_path(name))
        os.makedirs(os.path.dirname(mask), exist_ok=True)
        sky_img.save(mask)
        if feat_shape is not None:
            feat = os.path.join(root, _feature_path(name, "dinov2_vitb14"))
            os.makedirs(os.path.dirname(feat), exist_ok=True)
            np.save(feat, rng.standard_normal(feat_shape).astype(np.float16))
    for name in lidar_files:
        # in the sensor frame: the ground 1.84 m below, walls 20-70 m out
        az = rng.uniform(-np.pi, np.pi, n_lidar)
        el = rng.uniform(np.deg2rad(-30.0), np.deg2rad(10.0), n_lidar)
        d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1)
        ground = np.where(d[:, 2] < -1e-3, 1.84 / np.maximum(-d[:, 2], 1e-3), np.inf)
        ranges = np.minimum(ground, rng.uniform(20.0, 70.0, n_lidar))
        pts = np.zeros((n_lidar, 5), np.float32)
        pts[:, :3] = d * ranges[:, None]
        pts[:, 3] = rng.uniform(0, 255, n_lidar)
        pts[:, 4] = rng.integers(0, 32, n_lidar)
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        pts.tofile(path)
    return root


N_NUSC_CLI = 4  # optim.num_iters of phase 14's CLI run
N_NUSC_TIMED = 6  # iterations timed after it, on the trainer the CLI returns


def nuscenes_dotlist(root):
    """Phase 14's settings: the flagship's branches (dynamic, flow, shadow)
    on the stock defaults, the nuScenes loader on ``root`` with the six
    cameras at the default load size; render.render_full=false is a cut
    (the eval renders the lowres split of every image, not full-size)."""
    from emernerf_torch.flagship import _FLAGSHIP_DOTLIST

    return list(_FLAGSHIP_DOTLIST) + [
        "data.dataset=nuscenes", f"data.data_root={root}", "data.scene_idx=0",
        "data.pixel_source.num_cams=6", "render.render_full=false"]


def _kept_lidar(root, lidar_meta, lo, hi, cfg):
    """Returns of sweeps lo..hi-1 that the loader keeps: .pcd.bin as 5
    float32 per point, truncated on x by data.lidar_source's range."""
    lcfg = cfg.data.lidar_source
    n = 0
    for path in lidar_meta["filepath"][lo:hi]:
        x = np.fromfile(os.path.join(root, path), np.float32).reshape(-1, 5)[:, 0]
        n += int(((x < lcfg.truncated_max_range) & (x > lcfg.truncated_min_range)).sum())
    return n


def phase_nuscenes(dev, counted, zero, train_ms, busy5, peak5):
    """Phase 14: the nuScenes loader through the CLI.  Writes a devkit-layout
    scene (write_nuscenes_scene) to a temporary directory, trains
    N_NUSC_CLI iterations of the full-width flagship on its six
    asynchronous cameras and its lidar chain, evaluates; then checks that
    the first load cached the metas and that a second load (an end
    timestep at half the scene) reads them with the tables gone, and that
    the lidar returns loaded follow the scene_fraction rule in both; then
    on the trainer the CLI returns: N_NUSC_TIMED timed iterations
    (ms/iteration, peak memory) and a profile of 2 (device busy, idle
    share).  The launch counters are zeroed before the CLI run and read
    after the profiled iterations.  Returns (launches, ms/iteration, busy,
    peak GiB, load seconds)."""
    import logging
    import shutil
    import tempfile

    from emernerf_torch import train_emernerf
    from emernerf_torch.config import load_config
    from emernerf_torch.data import nuscenes
    from emernerf_torch.flagship import DEFAULT_CONFIG
    from emernerf_torch.train import trainer as trainer_mod

    print("phase 14: the nuScenes loader through the CLI (six asynchronous cameras, the lidar "
          "chain), full-width flagship")
    root = tempfile.mkdtemp(prefix="emernerf_nuscenes_")
    t_phase = t0 = time.perf_counter()
    write_nuscenes_scene(root)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    print(f"  wrote the scene in {time.perf_counter() - t0:.1f} s ({size / 2 ** 30:.2f} GiB): the "
          f"six cameras of CAMERA_LISTS[6] on 12 Hz chains of {NUSC_FRAMES}-{NUSC_FRAMES + 2} "
          f"JPEGs of {NUSC_HW[1]}x{NUSC_HW[0]} (shutters a sixth of a period apart, an ego "
          f"pose per image), sky masks, a 20 Hz LIDAR_TOP chain of {NUSC_LIDAR} returns per "
          "sweep, key frames at 2 Hz")
    print(f"  cuts: {NUSC_FRAMES} frames per camera (a 20 s scene has ~240); "
          f"render.render_full=false (the eval renders the lowres split); "
          f"{N_NUSC_CLI} + {N_NUSC_TIMED} + 2 training iterations")
    run_dir = os.path.join(root, "p", "nuscenes")
    os.makedirs(run_dir)
    log = logging.getLogger("emernerf_torch")
    handler = logging.FileHandler(os.path.join(run_dir, "log.txt"))
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    log.propagate = False
    argv = (["--output_root", root, "--project", "p", "--run_name", "nuscenes"]
            + nuscenes_dotlist(root) + [f"optim.num_iters={N_NUSC_CLI}", "logging.print_freq=1"])
    orig = trainer_mod.build_dataset_from_cfg
    loads = []

    def timed_load(cfg):
        t = time.perf_counter()
        out = orig(cfg)
        loads.append(time.perf_counter() - t)
        return out

    trainer_mod.build_dataset_from_cfg = timed_load
    trainer = None
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.synchronize()
        for fn in counted + tuple(zero):
            fn.launches = 0
        t0 = time.perf_counter()
        trainer = train_emernerf.main(argv)
        step = trainer.state.step
        print(f"  CLI run (load the scene, build, train {N_NUSC_CLI} iterations, evaluate): "
              f"{time.perf_counter() - t0:.1f} s; the dataset's load {loads[0]:.1f} s "
              "(the token walk, the metas written, images, masks and sweeps read)")
        ds = trainer.dataset
        metas = [os.path.join(root, "emernerf_metas", f"scene_000_{k}.json")
                 for k in ("camera", "lidar")]
        if not all(os.path.exists(m) for m in metas):
            fail("phase 14: the first load did not cache the metas")
        with open(metas[1]) as f:
            lidar_meta = json.load(f)
        n_total = len(lidar_meta["timestamp"])
        print(f"  dataset: {ds.num_images} images of {ds.image_hw} from {ds.num_cams} cameras, "
              f"{ds.num_frames} frames (the shortest chain), {len(ds.lidar['ranges'])} lidar rays "
              f"of {n_total} sweeps, scene_fraction {ds.scene_fraction}, aabb "
              f"{np.round(ds.aabb, 2).tolist()}; "
              f"{sum(p.numel() for p in trainer.state.params + trainer.state.prop_params)} params")
        if (ds.num_cams, ds.num_frames) != (6, NUSC_FRAMES):
            fail(f"phase 14: {ds.num_cams} cameras of {ds.num_frames} frames, expected 6 of "
                 f"{NUSC_FRAMES}")
        cfg = trainer.cfg
        if len(ds.lidar["ranges"]) != _kept_lidar(root, lidar_meta, 0, n_total, cfg):
            fail("phase 14: the lidar returns loaded do not follow the scene_fraction rule")
        with open(os.path.join(run_dir, "metrics.json")) as f:
            records = [json.loads(x) for x in f.read().splitlines()]
        losses = {k: records[-1][k] for k in ("rgb_loss", "sky_loss", "cycle_loss",
                                              "lidar_range_loss")}
        print(f"  losses at the last print: {losses}")
        with open(os.path.join(run_dir, f"metrics_all_{step}.json")) as f:
            results = json.load(f)
        keys = ("lowres/psnr", "lowres/ssim", "lidar/depth_rmse")
        print(f"  evaluation (random weights): {({k: results.get(k) for k in keys})}")
        if not all(np.isfinite(results.get(k, float("nan"))) for k in keys) or not all(
                np.isfinite(v) for v in losses.values()):
            fail(f"phase 14: losses or evaluation metrics missing or not finite: {results}")

        # the second load: cached metas, tables gone, half the scene
        tables = os.path.join(root, "v1.0-trainval")
        os.rename(tables, tables + ".gone")
        end = NUSC_FRAMES // 2 - 1
        cfg2 = load_config(DEFAULT_CONFIG, None, nuscenes_dotlist(root)
                           + [f"data.end_timestep={end}"])
        t0 = time.perf_counter()
        half = nuscenes.load_nuscenes_dataset(cfg2)
        secs2 = time.perf_counter() - t0
        l_end = int(n_total * half.scene_fraction)
        l_start = min(cfg2.data.start_timestep, max(l_end - 1, 0))
        want = _kept_lidar(root, lidar_meta, l_start, l_end, cfg2)
        print(f"  second load (cached metas, tables gone, data.end_timestep={end}): {secs2:.1f} s, "
              f"{half.num_frames} frames, scene_fraction {half.scene_fraction}, sweeps {l_start}-"
              f"{l_end - 1} of {n_total}: {len(half.lidar['ranges'])} lidar rays (rule: {want})")
        if half.num_frames != end + 1 or half.scene_fraction != (end + 1) / NUSC_FRAMES or len(
                half.lidar["ranges"]) != want:
            fail("phase 14: the cached-meta load or its lidar fraction is wrong")
        del half

        # the timed window on the CLI's trainer
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(N_NUSC_TIMED):
            trainer.train_iteration(step + i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / N_NUSC_TIMED
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rows, busy = profile_train(trainer, step + N_NUSC_TIMED, ms, "profile_train_nuscenes.json")
        share = profile_shares(rows, busy)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted + tuple(zero)}
        rays = 2 * trainer.ray_batch_size
        print(f"  {ms:.2f} ms/iteration ({N_NUSC_TIMED} iterations), {rays / ms * 1e3:.1f} rays/s, "
              f"device busy {busy:.2f} ms per iteration (idle {1 - busy / ms:.1%}), peak device "
              f"memory {peak:.2f} GiB; phase 5 (the synthetic scene, 1 camera): {train_ms:.2f} "
              f"ms/iteration, busy {busy5:.2f} ms, peak {peak5:.2f} GiB")
        for what, _ in PROFILE_SHARES:
            print(f"  {what}: {share[what]:.1%} of the device time")
        print(f"  launch counts (CLI run and timed iterations): {launches}")
        _check_launches(launches, {fn.__name__ for fn in zero}, "nuScenes run")
        print(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s")
        return launches, ms, busy, peak, loads[0]
    finally:
        trainer_mod.build_dataset_from_cfg = orig
        log.removeHandler(handler)
        handler.close()
        del trainer
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


N_REMAT_TIMED = 6  # timed iterations with optim.remat off, then on


def _snapshot(trainer):
    """The state a step reads and writes: params, both Adam states, the step
    and the trainer's generator."""
    st = trainer.state
    opt = [(o.count, [m.clone() for m in o.mu], [v.clone() for v in o.nu])
           for o in (st.opt_state, st.prop_opt_state)]
    return ([p.detach().clone() for p in st.params + st.prop_params], opt, st.step,
            trainer.generator.get_state())


@torch.no_grad()
def _restore(trainer, snap):
    params, opt, step, gen = snap
    st = trainer.state
    for p, q in zip(st.params + st.prop_params, params):
        p.copy_(q)
    for o, (count, mu, nu) in zip((st.opt_state, st.prop_opt_state), opt):
        o.count = count
        for a, b in zip(o.mu + o.nu, mu + nu):
            a.copy_(b)
    st.step = step
    trainer.generator.set_state(gen)


def _branch_grads(trainer, step_fn, lidar):
    """(losses, gradients in the order of the params, (GiB held after the
    forward for the backward, GiB of the peak above the start, GiB of the
    gradients)) of one branch's loss at the trainer's current params and
    generator state."""
    from emernerf_torch.data.scene import draw_lidar, draw_pixel, sample_lidar_batch, sample_pixel_batch
    from emernerf_torch.train.step import draw_step

    gen, scene, r = trainer.generator, trainer.scene, trainer.ray_batch_size
    if lidar:
        batch = sample_lidar_batch(scene, draw_lidar(scene, r, gen))
    else:
        batch = sample_pixel_batch(scene, draw_pixel(scene, r, gen), trainer.buffer_downscale,
                                   use_timestamps=trainer.model.has_dynamic)
    draws = draw_step(r, step_fn.render_kw(lidar), trainer.model.has_flow, gen, trainer.device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    total, aux = (step_fn.lidar_loss if lidar else step_fn.pixel_loss)(
        batch, draws, trainer.state.step, True)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    total.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    params = trainer.state.params + trainer.state.prop_params
    grads = [None if p.grad is None else p.grad.clone() for p in params]
    grad_bytes = sum(nbytes(g) for g in grads if g is not None)
    for p in params:
        p.grad = None
    return ({k: v.detach().clone() for k, v in aux.items()}, grads,
            tuple(x / 2 ** 30 for x in (held, peak, grad_bytes)))


def phase_remat(dev, counted):
    """Phase 15a: optim.remat on the full-width flagship (phase 5's scene).
    From one state (after 3 iterations) and the same draws, each branch's
    losses with remat off and on, bit for bit, and its gradients (K1
    backward's fp32 atomics and the index ops' add in any order: within
    2^-7 relative, one bf16 ulp, plus 1e-6 of the tensor's max |grad|, the
    spread of two runs without remat printed beside); then one whole
    iteration each way from that state: the pixel branch's losses bit for
    bit, the parameters after it finite (Adam moves an element by about lr
    whatever its gradient's size, so gradients at the rounding level move
    it either way: their differences are printed).  Then
    N_REMAT_TIMED timed iterations each way (after 2 warm-up ones), with
    peak memory, device busy from a profile of 2, and K1 forward's
    launches per iteration.  Returns {"off"|"on": (ms, busy, peak GiB, K1
    forward launches per iteration)}."""
    import dataclasses

    from emernerf_torch.flagship import flagship_config
    from emernerf_torch.ops.brickgrid import brickgrid_encode, brickgrid_encode_bwd
    from emernerf_torch.train.step import build_train_step
    from emernerf_torch.train.trainer import Trainer

    print("phase 15a: optim.remat on the full-width flagship (the field query recomputed in the "
          "backward): the same state and draws off and on, then timed iterations each way")
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = Trainer(flagship_config(), device=dev)
    off = trainer.train_step
    on = build_train_step(trainer.model, trainer.prop_models,
                          dataclasses.replace(trainer.step_cfg, remat=True))
    for i in range(3):
        trainer.train_iteration(i)
    snap = _snapshot(trainer)
    for lidar in (False, True):
        branch = "lidar" if lidar else "pixel"
        got = []
        for step_fn in (off, on, off):
            _restore(trainer, snap)
            got.append(_branch_grads(trainer, step_fn, lidar))
        (l_off, g_off, mem_off), (l_on, g_on, mem_on), (_, g_off2, _) = got
        same = all(torch.equal(l_off[k], l_on[k]) for k in l_off)
        print(f"  {branch} branch from one state: losses bit for bit off/on: {same} "
              f"({ {k: float(v) for k, v in l_on.items() if 'loss' in k} })")
        if not same:
            fail(f"phase 15a: the {branch} branch's losses differ with remat")
        worst, spread, n_exact = 0.0, 0.0, 0
        for a, b, c in zip(g_off, g_on, g_off2):
            if (a is None) != (b is None):
                fail(f"phase 15a: a gradient is missing with remat on or off ({branch})")
            if a is None:
                continue
            scale = float(a.abs().max())
            err = (a - b).abs()
            worst = max(worst, float(err.max()) / max(scale, 1e-30))
            spread = max(spread, float((a - c).abs().max()) / max(scale, 1e-30))
            n_exact += int(torch.equal(a, b))
            if bool((err > 2 ** -7 * a.abs() + 1e-6 * scale).any()):
                fail(f"phase 15a: {branch} gradients with remat beyond one bf16 ulp + 1e-6 "
                     f"of the max (worst {float(err.max()):.3e}, max |grad| {scale:.3e})")
        n = sum(g is not None for g in g_off)
        print(f"  {branch} gradients: {n_exact} of {n} tensors bit for bit; worst |off - on| "
              f"{worst:.3e} x the tensor's max |grad| (two runs without remat: {spread:.3e})")
        for mode, (held, peak, grad_gib) in (("off", mem_off), ("on", mem_on)):
            print(f"  {branch} branch, remat {mode}: {held:.3f} GiB held after the forward for "
                  f"the backward, peak {peak:.3f} GiB above the state's (the gradients "
                  f"{grad_gib:.3f} GiB of it)")
        del got, g_off, g_on, g_off2
    # one whole iteration each way from the same state
    _restore(trainer, snap)
    step = trainer.state.step
    m_off = trainer.train_iteration(step)
    after_off = [p.detach().clone() for p in trainer.state.params + trainer.state.prop_params]
    _restore(trainer, snap)
    trainer.train_step = on
    m_on = trainer.train_iteration(step)
    lr = float(m_off["lr"])
    lidar_keys = {"lidar_range_loss", "lidar_line_of_sight", "lidar_dynamic_loss",
                  "total_lidar_loss", "range_rmse"}
    pixel = sorted(set(m_off) - lidar_keys - {"lr", "pixel_rg", "lidar_rg"})
    same = all(torch.equal(torch.as_tensor(m_off[k]), torch.as_tensor(m_on[k])) for k in pixel)
    params = [p.detach() for p in trainer.state.params + trainer.state.prop_params]
    diff = max(float((p - q).abs().max()) for p, q in zip(params, after_off))
    moved = sum(int((p != q).sum()) for p, q in zip(params, after_off))
    total = sum(p.numel() for p in params)
    finite = all(bool(torch.isfinite(p).all()) for p in params)
    lidar_rel = {k: abs(float(m_on[k]) - float(m_off[k])) / max(abs(float(m_off[k])), 1e-30)
                 for k in sorted(lidar_keys & set(m_off))}
    print(f"  one iteration each way: pixel losses ({', '.join(pixel)}) bit for bit {same}; lidar "
          f"losses (after the pixel update) relative differences {lidar_rel}; parameters after "
          f"it: {moved} of {total} elements differ, max |diff| {diff:.3e} (lr {lr:.3e})")
    if not same or not finite:
        fail("phase 15a: the iteration with remat is not the one without")
    del snap, after_off
    torch.cuda.empty_cache()

    out = {}
    step = trainer.state.step + 1
    for label, step_fn in (("off", off), ("on", on)):
        trainer.train_step = step_fn
        for i in range(2):
            trainer.train_iteration(step + i)
        step += 2
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted:
            fn.launches = 0
        t1 = time.perf_counter()
        for i in range(N_REMAT_TIMED):
            trainer.train_iteration(step + i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3 / N_REMAT_TIMED
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = {fn.__name__: fn.launches / N_REMAT_TIMED for fn in counted}
        step += N_REMAT_TIMED
        _, busy = profile_train(trainer, step, ms, f"profile_train_remat_{label}.json")
        step += 2
        out[label] = (ms, busy, peak, launches["brickgrid_encode"])
        print(f"  remat {label}: {ms:.2f} ms/iteration, device busy {busy:.2f} ms (idle "
              f"{1 - busy / ms:.1%}), peak device memory {peak:.2f} GiB; launches per iteration "
              f"{launches}")
    if out["on"][3] <= out["off"][3]:
        fail("phase 15a: K1 forward did not launch again in the backward with remat")
    print(f"  phase 15a took {time.perf_counter() - t0:.1f} s")
    del trainer, off, on
    torch.cuda.empty_cache()
    return out


def interp_time(dataset):
    """(an off-grid normalized time, a training timestep): 0.3 of the way
    between the two middle training timesteps, and the later of them."""
    ts = dataset.unique_normalized_training_timestamps
    i = (len(ts) - 1) // 2
    return float(ts[i] + 0.3 * (ts[i + 1] - ts[i])), float(ts[i + 1])


def phase_interp(dev, profile, label, n_rays=2048):
    """Phase 15b on ``profile``: the eval-time temporal interpolation of the
    flow at full width in fp32, card against CPU: a chunk of ``n_rays``
    (phase_fp32_chunk) and a query_flow batch of 8,192 points at an
    off-grid time (the flows within 1e-3 of their largest |value|); then
    on the card at a training timestep, the interpolated chunk and
    query_flow bit for bit the exact ones."""
    from emernerf_torch.builders import build_dataset_from_cfg
    from emernerf_torch.eval.points import PointQueryEngine
    from emernerf_torch.eval.renderer import ImageRenderer
    from emernerf_torch.flagship import flagship_config

    t0 = time.perf_counter()
    interp = ["nerf.model.head.enable_temporal_interpolation=true"]
    t_off, t_grid = interp_time(build_dataset_from_cfg(flagship_config(profile=profile)))
    dataset, (gmodel, gprops), (cmodel, cprops), kw, rays = phase_fp32_chunk(
        dev, interp, profile, label, time_=t_off, n_rays=n_rays)
    g = np.random.default_rng(15)
    lo, hi = dataset.aabb[:3], dataset.aabb[3:]
    pts = g.uniform(lo, hi, (8192, 3)).astype(np.float32)
    times = np.full(len(pts), t_off, np.float32)
    got = PointQueryEngine(gmodel, device=dev).query_flow(pts, times)
    ref = PointQueryEngine(cmodel, device="cpu").query_flow(pts, times)
    for k in ref:
        err = float(np.abs(got[k] - ref[k]).max())
        scale = float(np.abs(ref[k]).max())
        print(f"  query_flow at t={t_off:.4f}, {len(pts)} points: {k} max abs diff {err:.3e} "
              f"(max |value| {scale:.3e}, tolerance 1e-3 of it)")
        if err > 1e-3 * max(scale, 1e-6):
            fail(f"{label}: interpolated query_flow {k} on the card disagrees with the CPU")
    # at a training timestep the interpolated queries are the exact ones
    rays = dict(rays, normed_timestamps=np.full_like(rays["normed_timestamps"], t_grid))
    pts_t = np.full(len(pts), t_grid, np.float32)
    out, flow = {}, {}
    for on in (True, False):
        gmodel.enable_temporal_interpolation = on
        out[on] = ImageRenderer(gmodel, gprops, device=dev, **kw).render_rays_chunked(rays)
        flow[on] = PointQueryEngine(gmodel, device=dev).query_flow(pts, pts_t)
    exact = all(np.array_equal(out[True][k], out[False][k]) for k in out[False]) and all(
        np.array_equal(flow[True][k], flow[False][k]) for k in flow[False])
    print(f"  at the training timestep t={t_grid:.4f}: the interpolated chunk ({sorted(out[True])}) "
          f"and query_flow bit for bit the exact ones: {exact}")
    if not exact:
        fail(f"{label}: at a training timestep the interpolated queries are not the exact ones")
    print(f"  {label} took {time.perf_counter() - t0:.1f} s")
    del gmodel, gprops, cmodel, cprops
    torch.cuda.empty_cache()
    return t_off


def phase_interp_kernels(dev, entries, t_off):
    """Phase 15b (kernels): K1 forward on the flagship's fused grid and K4
    forward on the reference-hash flow grid at the flow encodes that the
    interpolation adds to one 16,384-ray eval chunk, against their plain
    versions (K1 bit for bit in fp32 and in the flagship's bf16
    computation; K4 fp32 bit for bit, bf16 one rounding, rtol 2^-7): the
    chunk's samples (ray-ordered, 64 per ray) at their rays' nearer
    training timestep, and the warped points' flow queries (fused: the
    top-16 aggregation's 2 x 16 per ray; hash: all 64 samples' 2 x 64)."""
    from emernerf_torch.builders import build_dataset_from_cfg
    from emernerf_torch.flagship import flagship_config
    from emernerf_torch.ops.brickgrid import brickgrid_encode, brickgrid_encode_ref
    from emernerf_torch.ops.hashgrid import hashgrid_encode, hashgrid_encode_plain

    print("phase 15b (kernels): K1 and K4 forward vs plain versions at the interpolation's flow "
          "encodes of one eval chunk")
    t0 = time.perf_counter()
    ts = build_dataset_from_cfg(flagship_config()).unique_normalized_training_timestamps
    left = float(ts[np.argsort(np.abs(ts - t_off), kind="stable")[0]])
    g = torch.Generator(device=dev).manual_seed(15)
    cases = []
    for name, spec, fn, ref_fn, k in (
            ("dynflow", flagship_specs()["dynflow"], brickgrid_encode, brickgrid_encode_ref,
             AGG_TOPK),
            ("flow", hash_specs()["flow"], hashgrid_encode, hashgrid_encode_plain, NUM_SAMPLES)):
        xyz, xyzt = ray_batches(dev, g, N_RAYS, NUM_SAMPLES)
        n = N_RAYS * NUM_SAMPLES
        at_left = torch.cat([xyz, torch.full((n, 1), left, device=dev)], -1).contiguous()
        # the warped points of the aggregation (k per ray, both ways) at the left time
        warped = xyzt[n:].reshape(2, N_RAYS, NUM_SAMPLES, 4)[:, :, :k].reshape(-1, 4).clone()
        warped[:, 3] = left
        cases += [(name, spec, fn, ref_fn, "interp_left", at_left),
                  (name, spec, fn, ref_fn, "interp_warped_left", warped.contiguous())]
    with torch.no_grad():
        for name, spec, fn, ref_fn, batch, pos in cases:
            table32 = torch.rand(spec.table_shape, device=dev, generator=g) * 2 - 1
            brick = fn is brickgrid_encode
            touched = brick_touched(spec, pos) if brick else hash_touched(spec, pos)
            for label, dtype in ((("fp32", torch.float32), ("fp32->bf16", torch.bfloat16)) if brick
                                 else (("float32", torch.float32), ("bfloat16", torch.bfloat16))):
                if brick:
                    call = (lambda: fn(table32, pos, spec, dtype))
                    plain = (lambda: ref_fn(table32, pos, spec, dtype))
                    table_bytes = table32.element_size()
                else:
                    table = table32.to(dtype)
                    call = (lambda: fn(table, pos, spec))
                    plain = (lambda: ref_fn(table, pos, spec))
                    table_bytes = table.element_size()
                out, ref = call(), plain()
                tag = f"{fn.__name__}[{name},{batch},{label},N={pos.shape[0]}]"
                if brick or dtype == torch.float32:
                    mx = 0.0
                    exact = torch.equal(out, ref)
                    print(f"  {tag}: bit for bit with the plain version: {exact} (tolerance 0)")
                    if not exact:
                        fail(f"{tag}: kernel and plain version differ")
                else:
                    mx, over = compare(tag, out.float(), ref.float(), 2 ** -7, 1e-6)
                    if over:
                        fail(f"{tag}: {over} elements over tolerance")
                ms = cuda_ms(call, 10)
                plain_ms = cuda_ms(plain, 3)
                add_entry(entries, tag, "brickgrid.cu" if brick else "hashgrid.cu",
                          "emernerf_tpu/ops/brickgrid.py:581" if brick
                          else "emernerf_tpu/ops/hashgrid.py:408", fn, mx, ms, plain_ms,
                          nbytes(pos, out) + touched * table_bytes,
                          grid_ops(spec, pos.shape[0], False, False),
                          path="interp" if brick else "interp_hash")
                del out, ref
            del table32
    torch.cuda.empty_cache()
    print(f"  phase 15b (kernels) took {time.perf_counter() - t0:.1f} s")


def phase_sh(dev):
    """Phase 15c: spherical-harmonics directions: a 2,048-ray chunk of the
    full-width flagship in fp32, card against CPU (phase_fp32_chunk), one
    fp32 training step of the tiny flagship, card against CPU
    (phase_train_fp32), and 2 iterations of the full-width flagship
    through Trainer on the card, every loss finite."""
    from emernerf_torch.flagship import flagship_config
    from emernerf_torch.train.trainer import Trainer

    sh = ["nerf.model.head.direction_encoding=sh"]
    t0 = time.perf_counter()
    phase_fp32_chunk(dev, sh, label="phase 15c")
    torch.cuda.empty_cache()
    phase_train_fp32(dev, overrides=TINY_FP32 + tuple(sh), label="phase 15c (training)")
    trainer = Trainer(flagship_config(overrides=sh), device=dev)
    if trainer.model.direction_encoding != "sh":
        fail("phase 15c: the model does not encode directions by spherical harmonics")
    for i in range(2):
        losses = _losses(trainer.train_iteration(i))
        if not all(np.isfinite(v) for v in losses.values()):
            fail(f"phase 15c: non-finite loss {losses}")
    print(f"  full-width flagship with spherical harmonics, 2 iterations through Trainer: losses "
          f"{losses}")
    print(f"  phase 15c took {time.perf_counter() - t0:.1f} s")
    del trainer
    torch.cuda.empty_cache()


def main():
    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    print(f"phase 1: device {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(card_line)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    sys.path.insert(0, REPO)
    from emernerf_torch import kernels
    from emernerf_torch.flagship import DEFAULT_PROFILE, DYNAMIC, REFERENCE_BRICK, REFERENCE_HASH
    from emernerf_torch.ops.brickgrid import brickgrid_encode, brickgrid_encode_bwd
    from emernerf_torch.ops.hashgrid import features_minor, hashgrid_encode, hashgrid_encode_bwd
    from emernerf_torch.ops.stepfuns import (
        importance_sampling, interlevel_loss_levels, interlevel_loss_levels_bwd)
    from emernerf_torch.render.volrend import composite_along_rays, composite_along_rays_bwd
    from emernerf_torch.train.optim import adam_update

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = kernels.build(force=True)
    kernels.load()
    print(f"phase 2: built {lib_path.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    entries, after_timed = [], []
    phase_kernels(dev, entries, after_timed)
    phase_train_kernels(dev, entries)
    phase_loss_kernels(dev, entries, after_timed)
    phase_hash_kernels(dev, entries)
    brick = (brickgrid_encode, brickgrid_encode_bwd)
    hashed = (hashgrid_encode, hashgrid_encode_bwd, features_minor)
    forward = (importance_sampling, composite_along_rays)
    exact_launches, rays_per_s, eval_tally = phase_slice(dev, (brickgrid_encode,) + forward,
                                                         zero=hashed)
    phase_fp32_chunk(dev)
    shared = forward + (composite_along_rays_bwd, interlevel_loss_levels,
                        interlevel_loss_levels_bwd, adam_update)
    launches, ms_iter, train_rays_per_s, peak, share, tally = phase_train(
        dev, brick + shared, zero=hashed, shares=PROFILE_SHARES,
        table_casts_allowed=False)
    phase_train_fp32(dev)
    # the reference-hash profile: K4 in place of K1
    hash_launches, hash_ms, hash_rays_per_s, hash_peak, hash_share, hash_tally = phase_train(
        dev, hashed + shared, zero=brick, profile=REFERENCE_HASH, n_timed=8, label="phase 6",
        profile_file="profile_train_hash.json", shares=PROFILE_SHARES)
    _, hash_eval_rays_per_s, hash_eval_tally = phase_slice(
        dev, (hashgrid_encode, features_minor) + forward, zero=brick, profile=REFERENCE_HASH,
        label="phase 6b")
    phase_train_fp32(dev, REFERENCE_HASH, HASH_TINY_FP32, label="phase 6c")
    probe_launches = phase_probes(dev, entries, after_timed)
    cli_ms = phase_cli(dev, ms_iter)
    # the dynamic-only profile: K1 on the static and dynamic grids, no flow
    phase_profile_kernels(dev, entries, DYNAMIC, "dynamic", "phase 9")
    dyn = phase_train(dev, brick + shared, zero=hashed, profile=DYNAMIC, n_timed=6,
                      label="phase 9", profile_file="profile_train_dynamic.json",
                      shares=PROFILE_SHARES, table_casts_allowed=False, flow=False)
    _, dyn_eval_rays_per_s, dyn_eval_tally = phase_slice(
        dev, (brickgrid_encode,) + forward, zero=hashed, profile=DYNAMIC, label="phase 9b",
        flow=False)
    phase_train_fp32(dev, DYNAMIC, TINY_FP32, label="phase 9c")
    # the reference-semantics profile on brick grids: unpaired 4D rows,
    # separate dynamic and flow grids, every sample shaded and warped
    phase_profile_kernels(dev, entries, REFERENCE_BRICK, "reference_brick", "phase 10")
    ref = phase_train(dev, brick + shared, zero=hashed, profile=REFERENCE_BRICK, n_timed=6,
                      label="phase 10", profile_file="profile_train_reference_brick.json",
                      shares=PROFILE_SHARES, table_casts_allowed=False)
    _, ref_eval_rays_per_s, ref_eval_tally = phase_slice(
        dev, (brickgrid_encode,) + forward, zero=hashed, profile=REFERENCE_BRICK,
        label="phase 10b")
    phase_train_fp32(dev, REFERENCE_BRICK, HASH_TINY_FP32, label="phase 10c")
    phase_composite_shapes(dev, entries, after_timed, [
        (tally, "brick", True), (hash_tally, "hash", True), (dyn[5], "dynamic", True),
        (ref[5], "reference_brick", True), (eval_tally, "brick", False),
        (hash_eval_tally, "hash", False), (dyn_eval_tally, "dynamic", False),
        (ref_eval_tally, "reference_brick", False)])
    point_launches, pruned_tally = phase_points(
        dev, (brickgrid_encode, hashgrid_encode, features_minor) + forward,
        zero=(hashgrid_encode_bwd,))
    phase_points_kernels(dev, entries, after_timed, pruned_tally)
    # the feature head on a Waymo-layout scene (K3 past 64 channels)
    with open(os.path.join(REPO, "chiprun_out", "profile_train.json")) as f:
        busy5 = json.load(f)["busy_ms_per_iteration"]
    waymo = phase_waymo(dev, brick + shared, hashed, ms_iter, busy5, peak)
    phase_waymo_kernels(dev, entries, after_timed, waymo[1], waymo[2])
    # the nuScenes loader, then the three settings on the full-width flagship
    nusc = phase_nuscenes(dev, brick + shared, hashed, ms_iter, busy5, peak)
    remat = phase_remat(dev, brick)
    interp = ["nerf.model.head.enable_temporal_interpolation=true"]
    interp_launches, _, _ = phase_slice(dev, (brickgrid_encode,) + forward, zero=hashed,
                                        label="phase 15b", overrides=interp)
    interp_hash_launches, _, _ = phase_slice(
        dev, (hashgrid_encode, features_minor) + forward, zero=brick, profile=REFERENCE_HASH,
        label="phase 15b (hash)", overrides=interp)
    print(f"  K1 forward launches over the same 2 images: exact {exact_launches['brickgrid_encode']}"
          f", interpolated {interp_launches['brickgrid_encode']}")
    t_off = phase_interp(dev, DEFAULT_PROFILE, "phase 15b (fp32)")
    phase_interp(dev, REFERENCE_HASH, "phase 15b (hash, fp32)", n_rays=512)
    phase_interp_kernels(dev, entries, t_off)
    phase_sh(dev)
    kernel_only(after_timed)
    if "jax" in sys.modules or any(m.split(".")[0] in ("emernerf_tpu", "perf")
                                   for m in sys.modules):
        fail("jax, the JAX package or the repository's perf/ scripts were imported")

    # launches: the counts of the training run of each kernel's path
    runs = {"brick": launches, "hash": hash_launches, "probe": probe_launches,
            "dynamic": dyn[0], "reference_brick": ref[0], "points": point_launches,
            "waymo": waymo[0], "interp": interp_launches, "interp_hash": interp_hash_launches}
    report = [dict({k: v for k, v in e.items() if k not in ("fn", "path")},
                   launches=runs[e["path"]][e["fn"].__name__]) for e in entries]
    print(f"eval: {rays_per_s:.1f} rays/s; train: {ms_iter:.2f} ms/iteration, "
          f"{train_rays_per_s:.1f} rays/s, peak {peak:.2f} GiB, K1 backward "
          f"{share['K1 backward']:.1%}, K1 forward {share['K1 forward']:.1%}, copies, casts and "
          f"fills {share['copies, casts and fills']:.1%} of device time on {card_line}")
    print(f"reference-hash: eval {hash_eval_rays_per_s:.1f} rays/s; train {hash_ms:.2f} "
          f"ms/iteration, {hash_rays_per_s:.1f} rays/s, peak {hash_peak:.2f} GiB, K4 forward "
          f"{hash_share['K4 forward']:.1%} and backward {hash_share['K4 backward']:.1%} of "
          f"device time on {card_line}")
    print(f"CLI (brick): {cli_ms:.2f} ms/iteration on {card_line}")
    for what, (_, ms, rps, pk, sh, _), eval_rps in (("dynamic-only", dyn, dyn_eval_rays_per_s),
                                                    ("reference-brick", ref, ref_eval_rays_per_s)):
        print(f"{what}: eval {eval_rps:.1f} rays/s; train {ms:.2f} ms/iteration, {rps:.1f} "
              f"rays/s, peak {pk:.2f} GiB, K1 backward {sh['K1 backward']:.1%} and forward "
              f"{sh['K1 forward']:.1%} of device time on {card_line}")
    print(f"feature head (Waymo layout): train {waymo[3]:.2f} ms/iteration, busy {waymo[4]:.2f} "
          f"ms (without the head {waymo[7]:.2f}, {waymo[8]:.2f}), peak {waymo[5]:.2f} GiB, eval "
          f"peak {waymo[6]:.2f} GiB on {card_line}")
    print(f"nuScenes (6 cameras): train {nusc[1]:.2f} ms/iteration, busy {nusc[2]:.2f} ms (idle "
          f"{1 - nusc[2] / nusc[1]:.1%}), peak {nusc[3]:.2f} GiB, load {nusc[4]:.1f} s on "
          f"{card_line}")
    for label in ("off", "on"):
        ms, busy, pk, k1 = remat[label]
        print(f"remat {label}: train {ms:.2f} ms/iteration, busy {busy:.2f} ms, peak {pk:.2f} GiB, "
              f"K1 forward {k1:g} launches per iteration on {card_line}")
    print(json.dumps({"kernels": report}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
