#!/usr/bin/env python
"""Scatter-add formulations at the grid gradients' shapes, on the card (port
of ``perf/bench_scatter_alts.py``).

The same ``--case`` names, shapes and line per case (ms, Mrows/s, GB/s of
updates).  ``pallas`` runs P4, the one-hot tensor-core scatter-add written
by hand (``kernels/csrc/gather_scatter.cu``); the other cases were XLA
formulations on the TPU and are the plain PyTorch formulations of the same
work here: ``index_add_`` (base, width, merged), sort then ``index_add_``
(sorted, presorted), a chunked one-hot ``torch.matmul`` with bf16 operands
and fp32 accumulation (onehot, onehot2) and a strided subsample (sub).

Each case times one call with CUDA events (median of ``ITERS``); the TPU
script's remote-backend slope trick has no counterpart.  Inputs come from
a seeded generator.  No TPU number is a target here.

Usage: python -m emernerf_torch.perf.bench_scatter_alts [--case NAME] [--iters 6]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import torch

from emernerf_torch import resolve_device
from emernerf_torch.ops.gather_scatter import scatter_add_onehot
from emernerf_torch.perf import median_ms

ITERS = 6
N, NW = 524288, 262144  # rows per level of the static/fused grids; warped queries
ONEHOT_CHUNK = 65536


def make_inputs(n, t, w, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    rows = torch.randint(0, t, (n,), generator=g, device=device, dtype=torch.int32)
    upd = torch.randn((n, w), generator=g, device=device)
    return rows, upd


def report(name, n, w, ms):
    sec = ms / 1e3
    print(f"{name:34s} {ms:9.2f} ms   {n / sec / 1e6:8.1f} Mrows/s   "
          f"{n * w * 4 / sec / 1e9:7.1f} GB/s(upd)", flush=True)


def mm_bf16_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 operands with fp32 accumulation and output: the
    tensor cores on the card; on the CPU the fp32 product of the same
    (exactly representable) values."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def onehot_matmul(rows, upd, t, chunk=ONEHOT_CHUNK):
    """Dense one-hot product over row chunks: out[t] = sum_n 1[rows==t] upd."""
    n, w = upd.shape
    buf = torch.zeros((t, w), device=upd.device)
    ar = torch.arange(t, device=upd.device, dtype=torch.int32)
    for c in range(0, n, chunk):
        oh = (rows[c:c + chunk, None] == ar[None, :]).to(torch.bfloat16)
        buf += mm_bf16_f32(oh.T, upd[c:c + chunk].to(torch.bfloat16))
    return buf


# ------------------------------------------------------------------ #
def case_base(n, t, w, device, dtype=torch.float32, tag=""):
    rows, upd = make_inputs(n, t, w, device)
    upd = upd.to(dtype)
    ms = median_ms(lambda: torch.zeros((t, w), dtype=dtype, device=device).index_add_(0, rows, upd),
                   device, ITERS)
    report(f"base{tag} N={n} W={w} T={t} {str(dtype)[6:]}", n, w, ms)
    return ms


def case_sorted(n, t, w, device):
    rows, upd = make_inputs(n, t, w, device)

    def run():
        rs, order = torch.sort(rows)
        return torch.zeros((t, w), device=device).index_add_(0, rs, upd.index_select(0, order))

    ms = median_ms(run, device, ITERS)
    report(f"sorted N={n} W={w} T={t}", n, w, ms)
    return ms


def case_sorted_presort(n, t, w, device):
    """Scatter-only cost when the indices are already sorted."""
    rows, upd = make_inputs(n, t, w, device)
    rows = torch.sort(rows)[0]
    ms = median_ms(lambda: torch.zeros((t, w), device=device).index_add_(0, rows, upd),
                   device, ITERS)
    report(f"presorted N={n} W={w} T={t}", n, w, ms)
    return ms


def case_merged(n_per_level, t, w, device, levels=10):
    """ONE scatter of L*N rows into the full (L*T, W) table."""
    n = n_per_level * levels
    rows, upd = make_inputs(n, t, w, device)
    lvl = torch.arange(n, device=device, dtype=torch.int32) // n_per_level
    rows = rows + lvl * t
    ms = median_ms(lambda: torch.zeros((t * levels, w), device=device).index_add_(0, rows, upd),
                   device, ITERS)
    report(f"merged L={levels} N={n} W={w}", n, w, ms)
    return ms


def case_onehot(n, t, w, device, chunk=ONEHOT_CHUNK):
    rows, upd = make_inputs(n, t, w, device)
    ms = median_ms(lambda: onehot_matmul(rows, upd, t, chunk), device, ITERS)
    report(f"onehot N={n} W={w} T={t}", n, w, ms)
    return ms


def case_pallas_onehot(n, t, w, device, tile_n=2048):
    """P4: the one-hot tensor-core scatter-add written by hand."""
    rows, upd = make_inputs(n, t, w, device)
    ms = median_ms(lambda: scatter_add_onehot(rows, upd, t, tile_n), device, ITERS)
    report(f"pallas_onehot N={n} W={w} T={t}", n, w, ms)
    return ms


def case_sub4(n, t, w, device, k=4):
    """Scatter every k-th row, scaled by k (unbiased)."""
    rows, upd = make_inputs(n, t, w, device)
    m = n // k
    sel = k * torch.arange(m, device=device)

    def run():
        return torch.zeros((t, w), device=device).index_add_(
            0, rows.index_select(0, sel), upd.index_select(0, sel) * float(k))

    ms = median_ms(run, device, ITERS)
    report(f"sub{k} N={n}->{m} W={w} T={t}", n, w, ms)
    return ms


# ------------------------------------------------------------------ #
CASES = "base,width,sorted,merged,onehot,onehot2,pallas,sub".split(",")
# (T, W, tile_n) of the pallas case
PALLAS_SHAPES = ((512, 108, 2048), (4096, 108, 2048), (2048, 432, 2048), (4096, 432, 1024))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="all", choices=["all"] + CASES)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    globals()["ITERS"] = args.iters
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (host clock)"
    print(f"device: {name}", file=sys.stderr)

    def want(c):
        return args.case in ("all", c)

    if want("base"):
        case_base(N, 1 << 17, 108, dev)
        case_base(N, 1 << 15, 432, dev)
        case_base(NW, 1 << 15, 432, dev, tag="(warp)")
    if want("width"):
        case_base(N, 1 << 15, 432, dev, torch.bfloat16)
        case_base(N, 1 << 17, 108, dev, torch.bfloat16)
        case_base(N, 1 << 15, 216, dev)
        case_base(N, 1 << 15, 128, dev)
    if want("sorted"):
        case_sorted(N, 1 << 15, 432, dev)
        case_sorted_presort(N, 1 << 15, 432, dev)
        case_sorted(N, 1 << 17, 108, dev)
        case_sorted_presort(N, 1 << 17, 108, dev)
    if want("merged"):
        case_merged(N, 1 << 15, 108, dev, levels=10)
    if want("onehot"):
        case_onehot(N, 512, 108, dev)
        case_onehot(N, 4096, 108, dev)
        case_onehot(N, 4096, 432, dev)
    if want("onehot2"):
        case_onehot(N, 8192, 108, dev)
        case_onehot(N, 16384, 108, dev)
        case_onehot(N, 2048, 432, dev)
        case_onehot(N, 8192, 432, dev)
        case_onehot(NW, 4096, 432, dev)
    if want("pallas"):
        for t, w, tile_n in PALLAS_SHAPES:
            case_pallas_onehot(N, t, w, dev, tile_n)
    if want("sub"):
        case_sub4(N, 1 << 15, 432, dev, k=4)
        case_sub4(N, 1 << 15, 432, dev, k=8)
        case_sub4(N, 1 << 17, 108, dev, k=4)


if __name__ == "__main__":
    main()
