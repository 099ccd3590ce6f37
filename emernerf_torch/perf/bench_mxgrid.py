#!/usr/bin/env python
"""Times K12, the MX grid's line kernels (``ops/mxgrid.py``:
``mx_lines_encode`` and ``mx_lines_encode_bwd``), at the MX flagship's
training shapes, the calls ``chip_smoke.py`` phase 19a checks: one
8,192-ray branch's ray-ordered samples (``chip_smoke.ray_batches``), the
proposal grids at 128 and 64 samples a ray, the static and fused grids at
the 32 shaded samples, and the fused grid's 2 x 16 flow-warped samples with
position gradients; each with an fp32 computation and with the flagship's
bf16 computation on its fp32 lines.  Each row gives the median CUDA-event
time of one call (``ms``, the wrapper's host time in), the device time per
call with the host ahead of the card (``queued_ms``: calls queued behind a
sleep kernel) and the bound (``chip_smoke.bound`` of the bytes the call
must move and of ``chip_smoke.mx_ops``).

It uses only the wrappers' public functions and ``chip_smoke.py``'s shape
helpers, so the same file times another checkout of the port when copied
into it.  ``--save F`` writes every output (the forward's checksum, the
line and position gradients), ``--compare F`` holds them to another
checkout's: the forward bit for bit, the line gradient within rtol 1e-5
(2^-7 for a bf16 computation) + 1e-5 x its largest |grad|, the position
gradient within 1e-5 x its largest |grad|.  Run it from a checkout's root:

    python -m emernerf_torch.perf.bench_mxgrid [--save F | --compare F]

The last line is one JSON object of the times with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

ITERS = 10


def checksum(t: torch.Tensor):
    """(float64 sum, int64 sum of the raw bits): equal outputs, equal sums."""
    return [float(t.double().sum()), int(t.view(torch.int32).sum(dtype=torch.int64))]


def cases(cs, dev, g):
    """(name, spec key, positions, position gradients) of phase 19a."""
    n = cs.N_TRAIN
    xyz, xyzt = cs.ray_batches(dev, g, n, cs.SAMPLE_TOPK)
    warped = cs.ray_batches(dev, g, n, cs.AGG_TOPK)[1][n * cs.AGG_TOPK:].contiguous()
    return [("prop0", "prop0", cs.ray_batches(dev, g, n, cs.PROP_SAMPLES[0])[0], False),
            ("prop1", "prop1", cs.ray_batches(dev, g, n, cs.PROP_SAMPLES[1])[0], False),
            ("static", "static", xyz, False),
            ("fused", "dynflow", xyzt[:n * cs.SAMPLE_TOPK].contiguous(), False),
            ("fused,warped", "dynflow", warped, True)]


def compare(saved, outs):
    """Holds this checkout's outputs to a saved run's; returns the faults."""
    faults = []
    for tag, got in outs.items():
        ref = saved[tag]
        if got["out"] != ref["out"]:
            faults.append(f"{tag}: forward differs")
        rtol = 1e-5 if tag.endswith("fp32]") else 2 ** -7
        for key, r in (("d_lines", rtol), ("d_pos", 0.0)):
            a, b = got[key], ref[key]
            if a is None or b is None:
                if a is not b:
                    faults.append(f"{tag}.{key}: in one run only")
                continue
            err = (a - b).abs()
            over = int((err > 1e-5 * float(b.abs().max()) + r * b.abs()).sum())
            print(f"  {tag}.{key}: max abs diff {float(err.max()):.3e}, {over} over tolerance",
                  flush=True)
            if over:
                faults.append(f"{tag}.{key}: {over} elements over tolerance")
    return faults


def main(argv=None):
    import chip_smoke as cs
    from emernerf_torch.ops.mxgrid import init_mxgrid_table, mx_lines_encode, mx_lines_encode_bwd

    ap = argparse.ArgumentParser()
    ap.add_argument("--save")
    ap.add_argument("--compare")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_mxgrid: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    g = torch.Generator(device=dev).manual_seed(18)
    specs = cs.flagship_specs("mx")
    times, outs = {}, {}

    def row(tag, fn, n_bytes, n_ops):
        bound_ms, bound_by = cs.bound(n_bytes, n_ops)
        r = dict(ms=cs.cuda_ms(fn, ITERS), queued_ms=cs.queued_ms(fn, ITERS), bound_ms=bound_ms,
                 bound_by=bound_by)
        times[tag] = r
        print(f"{tag}: {r['ms']:.3f} ms, queued {r['queued_ms']:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {bound_ms / r['queued_ms']:.1%})", flush=True)

    for name, key, pos, pos_grad in cases(cs, dev, g):
        spec = specs[key]
        table = init_mxgrid_table(spec, device=dev, generator=g) * cs.MX_TABLE_SCALE
        lines = table[spec.part_sizes[0]:spec.num_parameters]
        n = pos.shape[0]
        cot = torch.randn((n, spec.n_scales * spec.n_features_per_level), device=dev,
                          generator=g)
        for compute in (torch.float32, torch.bfloat16):
            tag = f"[{name},N={n},{'fp32' if compute == torch.float32 else 'fp32->bf16'}]"
            out = mx_lines_encode(lines, pos, spec, compute)
            d_l, d_x = mx_lines_encode_bwd(lines, pos, cot, spec, pos_grad, compute)
            torch.cuda.synchronize()
            outs[tag] = dict(out=checksum(out), d_lines=d_l.float().cpu(),
                             d_pos=None if d_x is None else d_x.cpu())
            row(f"mx_lines_encode{tag}", lambda: mx_lines_encode(lines, pos, spec, compute),
                cs.nbytes(lines, pos, out), cs.mx_ops(spec, n, False, False))
            row(f"mx_lines_encode_bwd{tag}",
                lambda: mx_lines_encode_bwd(lines, pos, cot, spec, pos_grad, compute),
                cs.nbytes(lines, pos, cot, d_l, d_x), cs.mx_ops(spec, n, True, pos_grad))
            del out, d_l, d_x
        del table, lines, pos, cot
        torch.cuda.empty_cache()

    faults = []
    if args.save:
        torch.save(outs, args.save)
    if args.compare:
        faults = compare(torch.load(args.compare), outs)
        verdict = faults or "every output within tolerance"
        print(f"compare with {args.compare}: {verdict}", flush=True)
    print(json.dumps({"card": card, "times": times}))
    if faults:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
