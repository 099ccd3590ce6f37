#!/usr/bin/env python
"""Times the appearance embedding's lookup with its gradient, the route the
field takes (``models/fields.py:embedding_lookup``: the ray's index looked
up once and expanded over its samples, the table gradient a float64
one-hot product) against ``nn.Embedding``'s (``F.embedding`` on the
per-sample index, the field's route before it), at one pixel batch of the
stock configs (8,192 rays, the 32 shaded samples of ``sample_topk``, 16
channels) and at the table sizes the configs give: the synthetic
flagship's 8 images, nuScenes' 240 (6 cameras x 40 frames) and Waymo's
594 (3 cameras x 198 frames).  Each row: the median CUDA-event time of
one forward and one ``autograd.grad`` (``ms``), the device time of one
with the host ahead of the card (``queued_ms``: calls queued behind a
sleep kernel), the host time to issue one (``host_ms``), whether two
runs give the same gradient bit for bit, its largest difference from the
float64 sums, and for ``embedding_lookup`` whether it is the same with
TF32 matmuls allowed.  Run it from a checkout's root:

    python -m emernerf_torch.perf.bench_embedding

The last line is one JSON object of the rows with the card's name and
power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

ITERS = 20
RAYS, SAMPLES, DIM = 8192, 32, 16
ROWS = (8, 240, 594)


def host_ms(fn, iters=ITERS) -> float:
    """Median host time to issue one call of ``fn`` (the card not waited)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def main():
    import chip_smoke as cs
    from emernerf_torch.models.fields import embedding_lookup

    if not torch.cuda.is_available():
        raise SystemExit("bench_embedding: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    routes = {
        "embedding_lookup": lambda w, i: embedding_lookup(w, i),
        "nn.Embedding": lambda w, i: torch.nn.functional.embedding(i, w),
    }
    rows_out = []
    for n_rows in ROWS:
        g = torch.Generator(device=dev).manual_seed(n_rows)
        weight = torch.randn((n_rows, DIM), device=dev, generator=g).requires_grad_(True)
        idx = torch.randint(0, n_rows, (RAYS, 1), device=dev, generator=g).expand(RAYS, SAMPLES)
        cot = torch.randn((RAYS, SAMPLES, DIM), device=dev, generator=g)
        flat_idx = idx.reshape(-1)
        exact = torch.zeros((n_rows, DIM), dtype=torch.float64, device=dev).index_add_(
            0, flat_idx, cot.reshape(-1, DIM).double())
        for name, fn in routes.items():
            def step():
                return torch.autograd.grad(fn(weight, idx), weight, cot)[0]

            a, b = step(), step()
            row = {"route": name, "rows": n_rows, "indices": idx.numel(),
                   "ms": cs.cuda_ms(step, ITERS), "queued_ms": cs.queued_ms(step, ITERS),
                   "host_ms": host_ms(step), "bit_for_bit": bool(torch.equal(a, b)),
                   "max_abs_diff_runs": float((a - b).abs().max()),
                   "max_abs_err_vs_fp64": float((a.double() - exact).abs().max())}
            if name == "embedding_lookup":
                torch.backends.cuda.matmul.allow_tf32 = True
                row["same_with_tf32"] = bool(torch.equal(step(), a))
                torch.backends.cuda.matmul.allow_tf32 = False
            print(json.dumps(row))
            rows_out.append(row)
    print(card)
    print(json.dumps({"card": card, "rows": rows_out}))


if __name__ == "__main__":
    main()
