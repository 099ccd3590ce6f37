#!/usr/bin/env python
"""Times the grid encoders' kernels on the card: K1 forward (brick grids,
at the flagship eval shapes of one 16,384-ray chunk), K1 backward and K4
forward and backward (hash grids, at the shapes of one 8,192-ray pixel
branch), bf16 tables or computations, on uniform random points and on
ray-ordered samples (``chip_smoke.ray_batches``).  K1 forward is timed on
each route a checkout has: the table cast to bf16 then the bf16 kernel
(every checkout), the bf16 kernel alone, and the fp32 table with a bf16
computation (where ``brickgrid_encode`` takes ``compute_dtype``).

It uses only the wrappers' public functions and ``chip_smoke.py``'s shape
helpers, so the same file times another checkout of the port when copied
into it: run it from a checkout's root,

    python -m emernerf_torch.perf.bench_grid_kernels

Each line is the median of ``ITERS`` CUDA-event times of one call (the
wrapper's host time included); the last line is one JSON object of them
with the card's name and power limit.  It checks nothing: ``chip_smoke.py``
holds the kernels against their plain versions.
"""

from __future__ import annotations

import inspect
import json
import subprocess

import torch

ITERS = 10


def main():
    import chip_smoke as cs
    from emernerf_torch.ops import hashgrid
    from emernerf_torch.ops.brickgrid import brickgrid_encode, brickgrid_encode_bwd

    if not torch.cuda.is_available():
        raise SystemExit("bench_grid_kernels: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(21)
    times = {}

    def time(tag, fn):
        times[tag] = cs.cuda_ms(fn, ITERS)
        print(f"{tag}: {times[tag]:.3f} ms", flush=True)

    def table_and_cot(spec, n):
        table = (torch.rand(spec.table_shape, device=dev, generator=g) * 2 - 1).bfloat16()
        return table, torch.randn((n, spec.n_output_dims), device=dev, generator=g).bfloat16()

    bspecs = cs.flagship_specs()
    compute_arg = "compute_dtype" in inspect.signature(brickgrid_encode).parameters
    for name, samples in (("prop0", cs.PROP_SAMPLES[0]), ("prop1", cs.PROP_SAMPLES[1]),
                          ("static", cs.NUM_SAMPLES), ("dynflow", cs.NUM_SAMPLES)):
        spec = bspecs[name]
        xyz, xyzt = cs.ray_batches(dev, g, cs.N_RAYS, samples)
        rays = xyzt[:xyz.shape[0]].contiguous() if spec.n_input_dims == 4 else xyz
        del xyz, xyzt
        table32 = torch.rand(spec.table_shape, device=dev, generator=g) * 2 - 1
        table16 = table32.bfloat16()
        for kind, pos in (("uniform", torch.rand(rays.shape, device=dev, generator=g)),
                          ("rays", rays)):
            n = pos.shape[0]
            with torch.no_grad():
                time(f"K1 fwd {name} {kind} N={n} cast+bf16",
                     lambda: brickgrid_encode(table32.bfloat16(), pos, spec))
                time(f"K1 fwd {name} {kind} N={n} bf16", lambda: brickgrid_encode(table16, pos, spec))
                if compute_arg:
                    time(f"K1 fwd {name} {kind} N={n} fp32->bf16",
                         lambda: brickgrid_encode(table32, pos, spec, torch.bfloat16))
        del table32, table16, rays, pos
        torch.cuda.empty_cache()

    xyz, xyzt = cs.ray_batches(dev, g, cs.N_TRAIN, cs.NUM_SAMPLES)
    hspecs = cs.hash_specs()
    for name, rays, pos_grad in (("static", xyz, False), ("dynamic", xyzt, True)):
        spec = hspecs[name]
        for kind, pos in (("uniform", torch.rand(rays.shape, device=dev, generator=g)),
                          ("rays", rays)):
            table, cot = table_and_cot(spec, pos.shape[0])
            with torch.no_grad():
                time(f"K4 fwd {name} {kind} N={pos.shape[0]}",
                     lambda: hashgrid.hashgrid_encode(table, pos, spec))
            time(f"K4 bwd {name}{' pos_grad' if pos_grad else ''} {kind} N={pos.shape[0]}",
                 lambda: hashgrid.hashgrid_encode_bwd(table, pos, cot, spec, pos_grad))
        if hasattr(hashgrid, "features_minor"):
            time(f"features_minor {name} {tuple(table.shape)}",
                 lambda: hashgrid.features_minor(table))
        del table, cot
    del xyz, xyzt
    torch.cuda.empty_cache()

    n = cs.N_TRAIN * cs.SAMPLE_TOPK
    xyz, xyzt = cs.ray_batches(dev, g, cs.N_TRAIN, cs.SAMPLE_TOPK)
    warped = cs.ray_batches(dev, g, cs.N_TRAIN, cs.AGG_TOPK)[1][cs.N_TRAIN * cs.AGG_TOPK:]
    for name, rays, pos_grad in (("static", xyz, False), ("dynflow", xyzt[:n], False),
                                 ("dynflow", warped, True)):
        spec = bspecs[name]
        for kind, pos in (("uniform", torch.rand(rays.shape, device=dev, generator=g)),
                          ("rays", rays.contiguous())):
            table, cot = table_and_cot(spec, pos.shape[0])
            time(f"K1 bwd {name}{' warped' if pos_grad else ''} {kind} N={pos.shape[0]}",
                 lambda: brickgrid_encode_bwd(table, pos, cot, spec, pos_grad))
            del table, cot
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"card": card, "ms": times}))


if __name__ == "__main__":
    main()
