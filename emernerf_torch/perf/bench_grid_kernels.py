#!/usr/bin/env python
"""Times the grid encoders' training kernels on the card: K1 backward
(brick grids) and K4 forward and backward (hash grids), bf16 tables, at the
shapes of one 8,192-ray pixel branch, on uniform random points and on
ray-ordered samples (``chip_smoke.ray_batches``).

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

import json
import subprocess

import torch

ITERS = 10


def main():
    import chip_smoke as cs
    from emernerf_torch.ops import hashgrid
    from emernerf_torch.ops.brickgrid import brickgrid_encode_bwd

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

    bspecs = cs.flagship_specs()
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
