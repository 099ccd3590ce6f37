#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (emernerf_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero; nothing is skipped):
  1. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit;
  2. build: compiles kernels/csrc/*.cu with nvcc into build/emernerf_torch/;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the flagship eval shapes (one 16,384-ray chunk), with max abs/rel
     error, elements over tolerance and median times of both;
  4. slice: the full-width flagship (default bf16 config, seeded random
     weights) renders 2 images of 160x240 through ImageRenderer.render_split;
     every map must be finite and every kernel's launch counter above 0;
     then a 2,048-ray chunk in fp32 on the card (kernels) against the same
     params on the CPU (plain versions).
The last two lines are the card line and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_RAYS = 16384  # render.render_chunk_size
PROP_SAMPLES, NUM_SAMPLES = (128, 64), 64
TABLE_SCALE = 2000.0  # fp32 chunk: tables U(+-0.2) instead of U(+-1e-4)


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


def compare(name, out, ref, rtol, atol):
    """(max abs err, max rel err, elements over atol + rtol*|ref|)."""
    out, ref = out.double(), ref.double()
    err = (out - ref).abs()
    over = int((err > atol + rtol * ref.abs()).sum())
    rel = float((err / ref.abs().clamp_min(1e-12)).max()) if err.numel() else 0.0
    mx = float(err.max()) if err.numel() else 0.0
    print(f"  {name}: max_abs_err={mx:.3e} max_rel_err={rel:.3e} over_tol={over} "
          f"(rtol={rtol}, atol={atol}, n={out.numel()})")
    return mx, over


def phase_kernels(dev, kernels_entries):
    from emernerf_torch.builders import flow_spec, make_grid_spec, _enc_spec
    from emernerf_torch.flagship import flagship_config
    from emernerf_torch.ops.brickgrid import brickgrid_encode, brickgrid_encode_ref
    from emernerf_torch.ops.stepfuns import importance_sampling, importance_sampling_ref
    from emernerf_torch.render.volrend import composite_along_rays, composite_along_rays_ref
    import dataclasses

    cfg = flagship_config()
    m, enc = cfg.nerf.model, cfg.nerf.propnet.xyz_encoder
    dyn, flw = _enc_spec(m.dynamic_xyz_encoder), flow_spec()
    props = [make_grid_spec(3, enc.n_levels_per_prop[i], enc.base_resolutions_per_prop[i],
                            enc.max_resolution_per_prop[i], enc.lgo2_hashmap_size_per_prop[i], 1)
             for i in range(2)]
    # (name, spec, points per eval chunk)
    cases = [
        ("prop0", props[0], N_RAYS * PROP_SAMPLES[0]),
        ("prop1", props[1], N_RAYS * PROP_SAMPLES[1]),
        ("static", _enc_spec(m.xyz_encoder), N_RAYS * NUM_SAMPLES),
        ("dynflow", dataclasses.replace(dyn, n_features_per_level=dyn.n_features_per_level
                                        + flw.n_features_per_level), N_RAYS * NUM_SAMPLES),
    ]
    g = torch.Generator(device=dev).manual_seed(0)
    print("phase 3: kernels vs plain versions at the flagship eval shapes")
    with torch.no_grad():
        for name, spec, n in cases:
            pos = torch.rand((n, spec.n_input_dims), device=dev, generator=g)
            table32 = torch.rand(spec.table_shape, device=dev, generator=g) * 2 - 1
            for dtype, rtol, atol in ((torch.float32, 1e-5, 1e-6),
                                      (torch.bfloat16, 2 ** -7, 1e-6)):
                table = table32.to(dtype)
                out = brickgrid_encode(table, pos, spec)
                ref = brickgrid_encode_ref(table, pos, spec)
                tag = f"brickgrid_encode[{name},{str(dtype)[6:]},N={n}]"
                mx, over = compare(tag, out.float(), ref.float(), rtol, atol)
                if over:
                    fail(f"{tag}: {over} elements over tolerance")
                ms = cuda_ms(lambda: brickgrid_encode(table, pos, spec), 10)
                plain_ms = cuda_ms(lambda: brickgrid_encode_ref(table, pos, spec), 3)
                print(f"  {tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
                kernels_entries.append(dict(
                    name=tag, route="cuda", source="emernerf_torch/kernels/csrc/brickgrid.cu",
                    replaces="emernerf_tpu/ops/brickgrid.py:581", fn=brickgrid_encode,
                    max_abs_err=mx, ms=ms, plain_ms=plain_ms))
            del table32, table, pos

        # K2: the three sampling steps of one chunk, plus a jittered one
        for k1, n, jittered in ((2, 128, False), (129, 64, False), (65, 64, False),
                                (65, 64, True)):
            s = torch.sort(torch.rand((N_RAYS, k1), device=dev, generator=g), -1)[0]
            pdf = torch.rand((N_RAYS, k1), device=dev, generator=g) ** 4
            pdf[:, 0] = 0.0
            cdf = torch.cumsum(pdf, -1)
            cdf = cdf / cdf[:, -1:] * 0.97
            cdf[:64] = 0.0  # zero-opacity rays
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
            print(f"  {tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            kernels_entries.append(dict(
                name=tag, route="cuda", source="emernerf_torch/kernels/csrc/importance_sampling.cu",
                replaces="emernerf_tpu/ops/stepfuns.py:115", fn=importance_sampling,
                max_abs_err=mx, ms=ms, plain_ms=plain_ms))

        # K3: the full eval key set: 3 density sets, 23 value channels laid
        # out as render/volrend.py:composite_rays packs them
        s_ = NUM_SAMPLES
        t = torch.sort(torch.rand((N_RAYS, s_ + 1), device=dev, generator=g) * 100, -1)[0] + 0.1
        ts, te = t[:, :-1].contiguous(), t[:, 1:].contiguous()
        dens = torch.rand((N_RAYS, s_, 3), device=dev, generator=g) ** 3 * 0.5
        dens[:, :, 0] = dens[:, :, 1] + dens[:, :, 2]
        sets = [0] * 4 + [1] * 9 + [0] + [2] * 9
        vals = torch.rand((N_RAYS, s_, len(sets)), device=dev, generator=g)
        out = composite_along_rays(ts, te, dens, vals, sets)
        ref = composite_along_rays_ref(ts, te, dens, vals, sets)
        tag = f"composite_along_rays[R={N_RAYS},S={s_},D=3,C={len(sets)}]"
        mx = 0.0
        for field, a, b in zip(out._fields, out, ref):
            if field == "median_depth":
                moved = (a != b).squeeze(-1)
                frac = float(moved.float().mean())
                print(f"  {tag}.median_depth: {int(moved.sum())} of {N_RAYS} rays moved "
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
        plain_ms = cuda_ms(lambda: composite_along_rays_ref(ts, te, dens, vals, sets), 10)
        print(f"  {tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        kernels_entries.append(dict(
            name=tag, route="cuda", source="emernerf_torch/kernels/csrc/composite.cu",
            replaces="emernerf_tpu/render/volrend.py:33", fn=composite_along_rays,
            max_abs_err=mx, ms=ms, plain_ms=plain_ms))


def phase_slice(dev, counted):
    from emernerf_torch.eval.renderer import ImageRenderer
    from emernerf_torch.flagship import build_flagship

    print("phase 4: full-width flagship eval render (bf16 default config)")
    t0 = time.perf_counter()
    cfg, dataset, model, props = build_flagship(device=dev, seed=0)
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
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    frames, metrics = renderer.render_split(dataset, indices)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
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
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the render")
    del model, props, renderer
    torch.cuda.empty_cache()
    return launches, n_rays / secs


def _image_rays(dataset, idx):
    rays, gt = dataset.get_image_rays(idx)
    return rays, gt["hw"]


def phase_fp32_chunk(dev):
    from emernerf_torch.eval.renderer import ImageRenderer
    from emernerf_torch.flagship import build_flagship

    print("phase 4b: one 2,048-ray chunk in fp32, card (kernels) vs CPU (plain versions)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fp32 = ["nerf.model.table_dtype=float32", "nerf.model.mlp_dtype=float32"]
    cfg, dataset, gmodel, gprops = build_flagship(overrides=fp32, device=dev, seed=1)
    _, _, cmodel, cprops = build_flagship(overrides=fp32, device="cpu", seed=1)
    # scale the tables up from their U(+-1e-4) init so that density varies
    # along and across rays (random MLPs alone give a near-constant depth)
    with torch.no_grad():
        for pm in [gmodel, *gprops]:
            for name, p in pm.named_parameters():
                if name.endswith("table"):
                    p.mul_(TABLE_SCALE)
    cmodel.load_state_dict(gmodel.state_dict())
    for cp, gp in zip(cprops, gprops):
        cp.load_state_dict(gp.state_dict())
    rays, _ = dataset.get_image_rays(0)
    h, w = dataset.image_hw
    sl = slice(w * (h // 2), w * (h // 2) + 2048)  # rays across the image's middle rows
    rays = {k: v[sl] for k, v in rays.items()}
    kw = dict(num_samples=cfg.nerf.sampling.num_samples,
              prop_samples=tuple(cfg.nerf.propnet.num_samples_per_prop),
              near_plane=cfg.nerf.propnet.near_plane, far_plane=cfg.nerf.propnet.far_plane,
              sampling_type=cfg.nerf.propnet.sampling_type, chunk_size=2048,
              return_decomposition=True)
    out_gpu = ImageRenderer(gmodel, gprops, device=dev, **kw).render_rays_chunked(rays)
    t0 = time.perf_counter()
    out_cpu = ImageRenderer(cmodel, cprops, device="cpu", **kw).render_rays_chunked(rays)
    print(f"  CPU plain render of 2048 rays: {time.perf_counter() - t0:.1f} s")
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
        fail("fp32 chunk on the card disagrees with the CPU plain render")


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
    from emernerf_torch.ops.brickgrid import brickgrid_encode
    from emernerf_torch.ops.stepfuns import importance_sampling
    from emernerf_torch.render.volrend import composite_along_rays

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = kernels.build(force=True)
    kernels.load()
    print(f"phase 2: built {lib_path.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    entries = []
    phase_kernels(dev, entries)
    counted = (brickgrid_encode, importance_sampling, composite_along_rays)
    launches, rays_per_s = phase_slice(dev, counted)
    phase_fp32_chunk(dev)
    if "jax" in sys.modules:
        fail("jax was imported")

    report = [dict({k: v for k, v in e.items() if k != "fn"},
                   launches=launches[e["fn"].__name__]) for e in entries]
    print(f"slice: {rays_per_s:.1f} rays/s on {card_line}")
    print(json.dumps({"kernels": report}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
