#!/usr/bin/env python
"""Times P1 (``row_gather_loop``) and K3 forward (``composite_along_rays``)
on the card: P1 at the probe's two shapes (n = 2^22 rows of 128, fp32
t = 2^14 and bf16 t = 2^15), K3 forward at the eval shapes of one
16,384-ray chunk (no gradient, as the eval render calls it) and at the
training shapes of one 8,192-ray branch (densities that require a
gradient, as training calls it).  Each row gives the median CUDA-event
time of one wrapper call (host work included), the host's time per call
when 200 calls are issued back to back (host clock, no synchronise
inside), and the kernel's device time alone (torch.profiler, taken after
every wrapper time).

It uses only the wrappers' public functions and ``chip_smoke.py``'s timing
helpers, so the same file times another checkout of the port when copied
into it.  Run it from a checkout's root:

    python -m emernerf_torch.perf.bench_gather_composite [--save FILE | --compare FILE]

``--save`` writes K3 forward's outputs on these seeded inputs to FILE;
``--compare`` holds this checkout's outputs against such a file: every
output bit for bit but the weighted sums, whose order of addition may
differ (their largest difference is printed).  The last line is one JSON
object of the times with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

ITERS = 20
K3_KERNELS = ("composite_kernel", "composite_warp_kernel")  # K3 forward's two routes
EVAL_SETS = [0] * 4 + [1] * 9 + [0] + [2] * 9  # render/volrend.py:composite_rays' eval packing
# (rays, samples, density sets, channel sets, called with a gradient)
K3_SHAPES = [(16384, 64, 3, EVAL_SETS, False), (16384, 128, 1, [], False),
             (16384, 64, 1, [], False), (8192, 128, 1, [], True), (8192, 64, 1, [], True),
             (8192, 64, 1, [0] * 4, True)]


def _k3_inputs(dev, r, s, d, n_ch, grad, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.sort(torch.rand((r, s + 1), device=dev, generator=g) * 80, -1)[0] + 0.1
    dens = torch.rand((r, s, d), device=dev, generator=g) ** 3 * 0.5
    if d == 3:
        dens[:, :, 0] = dens[:, :, 1] + dens[:, :, 2]
    vals = torch.rand((r, s, n_ch), device=dev, generator=g) if n_ch else None
    return t[:, :-1].contiguous(), t[:, 1:].contiguous(), dens.requires_grad_(grad), vals


def _host_us(fn, n=200):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def main(argv=None):
    import chip_smoke as cs
    from emernerf_torch.ops import gather_scatter as gs
    from emernerf_torch.perf import pallas_experiments as pe
    from emernerf_torch.render.volrend import composite_along_rays

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save", help="write K3 forward's outputs here")
    ap.add_argument("--compare", help="hold K3 forward's outputs against this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_gather_composite: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    calls, outputs = [], {}
    for t, dtype in ((1 << 14, torch.float32), (1 << 15, torch.bfloat16)):
        table, idx = pe.make_table(t, 128, dtype, dev), pe.make_indices(pe.N, t, dev)
        calls.append((f"P1 row_gather_loop t={t} w=128 {str(dtype)[6:]} n={pe.N}",
                       ("gather_loop_kernel",), lambda table=table, idx=idx:
                       gs.row_gather_loop(table, idx)))
    for i, (r, s, d, sets, grad) in enumerate(K3_SHAPES):
        ts, te, dens, vals = _k3_inputs(dev, r, s, d, len(sets), grad, 40 + i)
        tag = f"K3 fwd R={r} S={s} D={d} C={len(sets)}{' grad' if grad else ''}"
        out = composite_along_rays(ts, te, dens, vals, sets)
        outputs[tag] = {k: v.detach().cpu() for k, v in zip(out._fields, out)}
        del out
        calls.append((tag, K3_KERNELS, lambda a=(ts, te, dens, vals, sets):
                      composite_along_rays(*a)))
    times = {tag: {"ms": cs.cuda_ms(fn, ITERS), "host_us": _host_us(fn)} for tag, _, fn in calls}
    for tag, keys, fn in calls:  # every profiler session after every wrapper time
        times[tag]["kernel_only_ms"] = cs.kernel_device_ms(fn, keys, iters=ITERS)
        print(f"{tag}: wrapper {times[tag]['ms']:.4f} ms, host {times[tag]['host_us']:.1f} us "
              f"per call, kernel alone {times[tag]['kernel_only_ms']:.4f} ms", flush=True)
    result = {"card": card, "times": times}
    if args.save:
        torch.save(outputs, args.save)
    if args.compare:
        other = torch.load(args.compare)
        same = {}
        for tag, out in outputs.items():
            exact = [k for k in out if k != "sums" and torch.equal(out[k], other[tag][k])]
            sums = (float((out["sums"] - other[tag]["sums"]).abs().max())
                    if out["sums"].numel() else 0.0)
            same[tag] = {"bit_for_bit": exact, "sums_max_abs_diff": sums}
            print(f"{tag}: bit for bit with {args.compare}: {exact}; sums differ by at most "
                  f"{sums:.3e}")
        result["compare"] = same
    print(json.dumps(result))


if __name__ == "__main__":
    main()
