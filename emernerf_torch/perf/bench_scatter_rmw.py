#!/usr/bin/env python
"""Times P3 (``scatter_add_rmw``) on the card at the shapes ``SHAPES``,
which ``chip_smoke.py`` phase 7 also checks the kernel at: the probe
entry point's (n = 2^22 update rows of 128 fp32 into a zeroed (2^13, 128)
table), odd widths, an update view at a 4-byte offset and every index
equal.  Each row gives the median CUDA-event time of one wrapper call (the
zero fill and the range check's ``aminmax`` and host sync included), the
kernel's device time alone (torch.profiler), the plain version's and
``index_add_``'s times, the bound (the bytes the call must move over the
HBM rate) and the largest difference from the plain version over its
largest |value|.

It uses only the wrapper's public function and ``chip_smoke.py``'s timing
helpers, so the same file times another checkout of the port when copied
into it.  Run it from a checkout's root:

    python -m emernerf_torch.perf.bench_scatter_rmw

The last line is one JSON object of the times with the card's name and
power limit.
"""

from __future__ import annotations

import json
import subprocess

import torch

ITERS = 20
P3_KERNELS = ("scatter_rmw_kernel",)


T = 1 << 13  # table rows
# (n, w, element offset of the update view, every index 0): the probe entry
# point's shape, odd widths (float and float2 reductions), a view at a
# 4-byte offset (p3_plan narrows) and every index 0 (the worst contention)
SHAPES = ((1 << 22, 128, 0, False), (1 << 18, 1, 0, False), (1 << 18, 3, 0, False),
          (1 << 18, 6, 0, False), (1 << 18, 130, 0, False), (1 << 20, 128, 1, False),
          (4096, 128, 0, True))


def tag(n, w, offset, equal) -> str:
    return (f"scatter_add_rmw[t={T},w={w},f32,n={n}"
            f"{',upd at +4 bytes' if offset else ''}{',every index 0' if equal else ''}]")


def make_inputs(dev, n, w, offset, equal, seed=2):
    """Seeded indices into T rows and (n, w) updates, a view ``offset``
    elements into a flat buffer."""
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, T, (n,), generator=g, device=dev, dtype=torch.int32)
    if equal:
        idx.zero_()
    flat = torch.randn((n * w + offset,), generator=g, device=dev)
    return idx, flat[offset:].view(n, w)


def main(argv=None):
    import chip_smoke as cs
    from emernerf_torch.ops import gather_scatter as gs

    if not torch.cuda.is_available():
        raise SystemExit("bench_scatter_rmw: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    times = {}
    t = T
    for n, w, offset, equal in SHAPES:
        name = tag(n, w, offset, equal)
        idx, upd = make_inputs(dev, n, w, offset, equal)
        out, ref = gs.scatter_add_rmw(idx, upd, t), gs.scatter_add_plain(idx, upd, t)
        err = float((out - ref).abs().max() / ref.abs().max())
        del out, ref
        fn = lambda idx=idx, upd=upd, t=t: gs.scatter_add_rmw(idx, upd, t)  # noqa: E731
        row = dict(ms=cs.cuda_ms(fn, ITERS),
                   plain_ms=cs.cuda_ms(lambda: gs.scatter_add_plain(idx, upd, t), ITERS),
                   library_ms=cs.cuda_ms(lambda: torch.zeros((t, w), device=dev).index_add_(
                       0, idx, upd), ITERS),
                   kernel_only_ms=cs.kernel_device_ms(fn, P3_KERNELS, iters=ITERS),
                   bound_ms=cs.bound(4 * (n + n * w + t * w), float(n * w))[0],
                   max_err_over_max=err)
        times[name] = row
        print(f"{name}: call {row['ms']:.4f} ms, kernel alone {row['kernel_only_ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f}, index_add_ {row['library_ms']:.4f}, bound "
              f"{row['bound_ms']:.4f} ({row['bound_ms'] / row['kernel_only_ms']:.1%} alone, "
              f"{row['bound_ms'] / row['ms']:.1%} the call); max |diff| / max |value| {err:.2e}",
              flush=True)
        del idx, upd
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "times": times}))


if __name__ == "__main__":
    main()
