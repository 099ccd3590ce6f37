#!/usr/bin/env python
"""Row gather and scatter-add probes on the card (port of
``perf/pallas_experiments.py``).

The same cases, names and line per case as the TPU probes, each through
the port's hand-written kernel (``kernels/csrc/gather_scatter.cu``):

  g1: loop gather, a warp per 32 rows with the widest aligned vectors (P1)
  g2: take gather, 2048 indices per block staged in shared memory, one
      warp per row (P2)
  s1: scatter-add by fp32 atomics into a zeroed table (P3)

On the TPU the tables (4-8 MiB) sit in VMEM; on the H100 they stay in
device memory and the 50 MB L2 holds them.  Times are CUDA-event medians
of one call over ``ITERS`` calls; inputs come from a seeded generator.
No TPU number is a target here.

Usage: python -m emernerf_torch.perf.pallas_experiments [--quick] [--only NAME]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import torch

from emernerf_torch import resolve_device
from emernerf_torch.ops.gather_scatter import (
    row_gather_loop,
    row_gather_take,
    scatter_add_rmw,
)
from emernerf_torch.perf import median_ms

ITERS = 6
N, N_QUICK = 1 << 22, 1 << 20


def make_table(t: int, width: int, dtype, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(0)
    return torch.randn((t, width), generator=g, device=device).to(dtype)


def make_indices(n: int, t: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(1)
    return torch.randint(0, t, (n,), generator=g, device=device, dtype=torch.int32)


def _result(n: int, ms: float):
    return dict(rows_per_s=n / ms * 1e3, ms=ms)


def bench_gather_loop(n, t, width, dtype, device):
    table, idx = make_table(t, width, dtype, device), make_indices(n, t, device)
    return _result(n, median_ms(lambda: row_gather_loop(table, idx), device, ITERS))


def bench_gather_take(n, t, width, dtype, device):
    table, idx = make_table(t, width, dtype, device), make_indices(n, t, device)
    return _result(n, median_ms(lambda: row_gather_take(table, idx), device, ITERS))


def bench_scatter_rmw(n, t, width, dtype, device):
    idx = make_indices(n, t, device)
    g = torch.Generator(device=device).manual_seed(2)
    upd = torch.randn((n, width), generator=g, device=device).to(dtype)
    return _result(n, median_ms(lambda: scatter_add_rmw(idx, upd, t), device, ITERS))


def cases(n: int, device):
    """(name, thunk) of every probe, at n rows."""
    return [
        ("g1 loop-gather t=2^14 w=128 f32",
         lambda: bench_gather_loop(n, 1 << 14, 128, torch.float32, device)),
        ("g1 loop-gather t=2^15 w=128 bf16",
         lambda: bench_gather_loop(n, 1 << 15, 128, torch.bfloat16, device)),
        ("g2 take-gather t=2^14 w=128 f32",
         lambda: bench_gather_take(n, 1 << 14, 128, torch.float32, device)),
        ("s1 rmw-scatter t=2^13 w=128 f32",
         lambda: bench_scatter_rmw(n, 1 << 13, 128, torch.float32, device)),
    ]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--only", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    n = N_QUICK if args.quick else N
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (host clock)"
    print(f"device: {name}", file=sys.stderr)
    for case, fn in cases(n, device):
        if args.only and args.only not in case:
            continue
        r = fn()
        print(f"{case:45s} {r['rows_per_s'] / 1e6:9.1f} Mrows/s {r['ms']:9.2f} ms", flush=True)


if __name__ == "__main__":
    main()
