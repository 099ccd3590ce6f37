#!/usr/bin/env python
"""Times K3 (``composite_along_rays``, forward and backward) on the card at
the feature head's shapes, past 64 value channels: the training
composite (8,192 rays of 64 samples, one density set, 68 channels:
shadow_ratio^2, rgb, dino_feat) forward with a gradient and backward with
every cotangent, and one eval chunk with the decomposition (16,384 rays,
three density sets, 215 channels: the 23 of the decomposition, then
dino_feat, static_dino and dynamic_dino) forward.  The eval chunk is timed
as one call and as the JAX package's shape of the work, four calls by
channel group, each recomputing the weights; the split's sums must equal
the one call's.

Each row gives the host's time to issue one call (200 calls back to back,
no synchronise), the CUDA-event time of one call (host work included), of
a call in a stream of ten, of a call queued behind a sleep kernel (the
device's time alone: chip_smoke.queued_ms), and each kernel's device time
per launch (torch.profiler, launches counted), in a fresh process.  Run
from a checkout's root:

    python -m emernerf_torch.perf.bench_wide_composite

The last line is one JSON object of the times with the card's name and
power limit.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

ITERS = 20


def _host_ms(fn, n=200):
    for _ in range(3):  # warm-up: the allocator's blocks
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e3


def _device_ms(fn, iters=ITERS):
    """{kernel name: (ms per launch, launches per call)} of fn()."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    def name(key):
        return key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]

    return {name(e.key): (e.device_time_total / e.count / 1e3, e.count / iters)
            for e in prof.key_averages() if e.device_time_total > 0}


def main():
    import chip_smoke as cs
    from emernerf_torch.render.volrend import composite_along_rays, composite_along_rays_bwd

    if not torch.cuda.is_available():
        raise SystemExit("bench_wide_composite: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    sets = cs.EVAL_SETS + [0] * 64 + [1] * 64 + [2] * 64
    ts, te, dens, vals = cs.composite_inputs(dev, 80, cs.N_RAYS, cs.NUM_SAMPLES, 3, len(sets),
                                             80.0, False)
    groups = [(0, 23), (23, 87), (87, 151), (151, 215)]
    parts = [vals[..., a:b].contiguous() for a, b in groups]
    tr = cs.composite_inputs(dev, 81, cs.N_TRAIN, cs.NUM_SAMPLES, 1, 68, 80.0, True)
    bwd = cs.composite_bwd_inputs(dev, 70, cs.NUM_SAMPLES, True, 68)

    def one_call():
        return composite_along_rays(ts, te, dens, vals, sets)

    def four_calls():
        return [composite_along_rays(ts, te, dens, v, sets[a:b])
                for v, (a, b) in zip(parts, groups)]

    if not torch.allclose(one_call().sums, torch.cat([o.sums for o in four_calls()], -1),
                          rtol=1e-6, atol=1e-6):
        raise SystemExit("bench_wide_composite: the split calls' sums differ from the one call's")
    calls = {
        "fwd R=8192 S=64 D=1 C=68 grad": (lambda: composite_along_rays(*tr, [0] * 68),
                                          cs.nbytes(*tr[:3], tr[3])),
        "bwd R=8192 S=64 D=1 C=68 every cotangent": (lambda: composite_along_rays_bwd(*bwd),
                                                     cs.nbytes(*bwd[:4], *bwd[5])),
        "fwd R=16384 S=64 D=3 C=215, one call": (one_call, cs.nbytes(ts, te, dens, vals)),
        "fwd R=16384 S=64 D=3 C=215, four calls by channel group": (
            four_calls, cs.nbytes(ts, te, dens, vals)),
    }
    times = {}
    for tag, (fn, n_in) in calls.items():
        times[tag] = {"host_ms": _host_ms(fn), "event_ms": cs.cuda_ms(fn, ITERS),
                      "stream_ms": cs.cuda_ms(lambda: [fn() for _ in range(10)], 5) / 10,
                      "queued_ms": cs.queued_ms(fn, ITERS), "input_mb": n_in / 1e6}
    for tag, (fn, _) in calls.items():  # every profiler session after every time
        kern = _device_ms(fn)
        times[tag]["kernels"] = kern
        times[tag]["device_ms"] = sum(ms * n for ms, n in kern.values())
        t = times[tag]
        print(f"{tag}: host {t['host_ms']:.4f} ms per call, events {t['event_ms']:.4f} ms, in a "
              f"stream of ten {t['stream_ms']:.4f} ms per call, queued {t['queued_ms']:.4f} ms, "
              f"device {t['device_ms']:.4f} ms "
              f"({', '.join(f'{k} {ms:.4f} x{n:g}' for k, (ms, n) in kern.items())})", flush=True)
    print(json.dumps({"card": card, "times": times}))


if __name__ == "__main__":
    main()
