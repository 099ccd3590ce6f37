"""The port's probe entry points (counterparts of the repository's
``perf/`` scripts that reach ``pl.pallas_call``) and their timer."""

from __future__ import annotations

import statistics
import time

import torch


def median_ms(fn, device: torch.device, iters: int) -> float:
    """Median time of one ``fn()`` call in ms after one warm-up: CUDA events
    on the card; the host clock on the CPU (not a device number)."""
    fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(device)
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)
