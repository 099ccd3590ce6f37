#!/usr/bin/env python
"""Times K5 (the interlevel loss, forward and backward) and K3 backward
(the compositing gradient) on the card, at the calls of one 8,192-ray
training branch of the flagship:

* K5 through ``compute_prop_loss`` on both cache levels (129 and 65 edges,
  pulse widths 0.03 and 0.003) against the 65-edge final distribution,
  the CDFs requiring a gradient as training has them: the forward call,
  then the backward alone (``torch.autograd.grad`` on the retained graph);
* K3 backward through ``composite_along_rays`` and autograd: the two
  proposal levels' calls (8192, 128, 1) and (8192, 64, 1) with the
  transmittance's cotangent alone, and the pixel branch's final composite
  (8192, 64, 1) with four value channels and the cotangents of the
  weights, opacity, depth and sums.

Each also through its wrappers alone, without autograd (K5: the grouped
call where the checkout has ``interlevel_loss_levels``, else the one-level
``interlevel_loss`` and ``interlevel_loss_bwd`` once per level; K3:
``composite_along_rays_bwd``).  Each row gives the median CUDA-event time
of one call (host work included), the host's time per call when 200 calls
are issued back to back (host clock, no synchronise inside; the median of
5 such batches), the kernel's device time alone (torch.profiler, taken
after every other time) and the bound: the bytes the call must move (each
input read once, each output written once) over 3.35 TB/s.

It uses only public functions and ``chip_smoke.py``'s timing helpers, so
the same file times another checkout of the port when copied into it.  Run
it from a checkout's root:

    python -m emernerf_torch.perf.bench_loss_kernels [--save FILE | --compare FILE]

``--save`` writes the outputs (K5's loss and gradients, K3 backward's
gradients) on these seeded inputs to FILE; ``--compare`` prints the largest
difference of each from such a file and whether it is bit for bit.  The
last line is one JSON object of the times with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

ITERS = 20
R = 8192
HBM_BYTES_PER_S = 3.35e12
PROP_SAMPLES, NUM_SAMPLES, PULSE_WIDTHS = (128, 64), 64, (0.03, 0.003)
# (samples, value channels): the proposal levels, then the pixel branch's
# final composite
K3_CALLS = ((128, 0), (64, 0), (64, 4))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _host_us(fn, n=200, batches=5):
    """Median over ``batches`` of the host's time per call of n calls
    issued back to back (the host's clock is noisy on a shared machine)."""
    per_call = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per_call.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def _k5_inputs(dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def edges(k1):  # strictly increasing from 0 to 1
        s = torch.cumsum(torch.rand((R, k1), device=dev, generator=g) + 0.05, -1)
        s = s - s[:, :1]
        return (s / s[:, -1:]).contiguous()

    def cdf(k1):
        w = torch.rand((R, k1 - 1), device=dev, generator=g) ** 4
        c = torch.cat([torch.zeros_like(w[:, :1]), torch.cumsum(w, -1)], -1)
        return (c / c[:, -1:] * 0.99).contiguous()

    s_final = edges(NUM_SAMPLES + 1)
    trans = (1.0 - cdf(NUM_SAMPLES + 1)[:, :-1]).contiguous()
    caches_s = [edges(n + 1) for n in PROP_SAMPLES]
    cdfs = [cdf(n + 1).requires_grad_(True) for n in PROP_SAMPLES]
    return caches_s, cdfs, s_final, trans


def _k3_inputs(dev, seed, s, c):
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.sort(torch.rand((R, s + 1), device=dev, generator=g) * 80, -1)[0] + 0.1
    dens = (torch.rand((R, s, 1), device=dev, generator=g) ** 3 * 0.5).requires_grad_(True)
    vals = torch.rand((R, s, c), device=dev, generator=g).requires_grad_(True) if c else None
    rnd = lambda *shape: torch.randn(shape, device=dev, generator=g)  # noqa: E731
    # cotangents of (weights, trans, opacity, depth, sums)
    cots = ((rnd(R, s, 1), None, rnd(R, 1), rnd(R, 1), rnd(R, c)) if c else
            (None, rnd(R, s, 1), None, None, None))
    return t[:, :-1].contiguous(), t[:, 1:].contiguous(), dens, vals, cots


def main(argv=None):
    import chip_smoke as cs
    from emernerf_torch.ops import stepfuns
    from emernerf_torch.render.prop_sampler import PropCache, compute_prop_loss
    from emernerf_torch.render.volrend import composite_along_rays, composite_along_rays_bwd

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save", help="write the outputs here")
    ap.add_argument("--compare", help="hold the outputs against this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_loss_kernels: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    rows, outputs = [], {}

    # K5: compute_prop_loss forward, then its backward alone
    caches_s, cdfs, s_final, trans = _k5_inputs(dev, 50)
    caches = [PropCache(s, c, i) for i, (s, c) in enumerate(zip(caches_s, cdfs))]

    def k5_forward():
        return compute_prop_loss(caches, s_final, trans, True, PULSE_WIDTHS)

    loss = k5_forward()
    outputs["K5 loss"] = loss.detach().cpu()
    grads = torch.autograd.grad(loss, cdfs, retain_graph=True)
    for i, gr in enumerate(grads):
        outputs[f"K5 d cdfs level {i}"] = gr.cpu()
    w_s = [torch.empty((R, c.shape[1] - 1), device=dev) for c in cdfs]  # sizes only
    per_ray = torch.empty((len(cdfs), R), device=dev)
    tag = (f"K5 fwd R={R} K+1={NUM_SAMPLES + 1} M+1={tuple(n + 1 for n in PROP_SAMPLES)} "
           f"r={PULSE_WIDTHS}")
    fwd_bytes = _nbytes(s_final, trans, *caches_s, *cdfs, *w_s, per_ray)
    bwd_bytes = _nbytes(*w_s, *cdfs, per_ray, *cdfs)
    rows.append((tag, ("interlevel_fwd_kernel",), k5_forward, fwd_bytes))
    rows.append((tag.replace("fwd", "bwd"), ("interlevel_bwd_kernel",),
                 lambda: torch.autograd.grad(loss, cdfs, retain_graph=True), bwd_bytes))
    # the same K5 work through its wrappers alone, without autograd and the
    # loss's reduction: the grouped wrapper where the checkout has it, else
    # the one-level wrapper once per level
    plain = [c.detach() for c in cdfs]
    w_ref = [stepfuns.interlevel_loss_ref(s_final, trans, r, s, c)[0]
             for s, c, r in zip(caches_s, plain, PULSE_WIDTHS)]
    g_loss = torch.rand((len(cdfs), R), device=dev)
    if hasattr(stepfuns, "interlevel_loss_levels"):
        fwd = lambda: stepfuns.interlevel_loss_levels(  # noqa: E731
            caches_s, plain, s_final, trans, PULSE_WIDTHS)
        bwd = lambda: stepfuns.interlevel_loss_levels_bwd(w_ref, plain, g_loss)  # noqa: E731
        how = "one grouped call"
    else:
        fwd = lambda: [stepfuns.interlevel_loss(s, c, s_final, trans, r)  # noqa: E731
                       for s, c, r in zip(caches_s, plain, PULSE_WIDTHS)]
        bwd = lambda: [stepfuns.interlevel_loss_bwd(w, c, g)  # noqa: E731
                       for w, c, g in zip(w_ref, plain, g_loss)]
        how = "a call per level"
    rows.append((f"{tag} wrapper ({how})", ("interlevel_fwd_kernel",), fwd, fwd_bytes))
    rows.append((f"{tag.replace('fwd', 'bwd')} wrapper ({how})", ("interlevel_bwd_kernel",),
                 bwd, bwd_bytes))

    # K3 backward: composite_along_rays forward once, its backward alone
    for i, (s, c) in enumerate(K3_CALLS):
        ts, te, dens, vals, cots = _k3_inputs(dev, 60 + i, s, c)
        out = composite_along_rays(ts, te, dens, vals, [0] * c)
        pairs = [(o, g) for o, g in zip((out.weights, out.trans, out.opacity, out.depth,
                                         out.sums), cots) if g is not None]
        inputs = [dens] + ([vals] if c else [])
        tag = f"K3 bwd R={R} S={s} D=1 C={c} {'w/opacity/depth/sums' if c else 'trans'}"
        got = torch.autograd.grad([o for o, _ in pairs], inputs, [g for _, g in pairs],
                                  retain_graph=True)
        for name, gr in zip(("d dens", "d vals"), got):
            outputs[f"{tag} {name}"] = gr.cpu()
        n_bytes = _nbytes(ts, te, dens, vals, *cots, *got)
        rows.append((tag, ("composite_bwd_kernel",),
                     lambda pairs=pairs, inputs=inputs: torch.autograd.grad(
                         [o for o, _ in pairs], inputs, [g for _, g in pairs],
                         retain_graph=True), n_bytes))
        # the wrapper alone, without autograd
        rows.append((f"{tag} wrapper", ("composite_bwd_kernel",),
                     lambda a=(ts, te, dens.detach(), None if vals is None else vals.detach(),
                               [0] * c, cots): composite_along_rays_bwd(*a), n_bytes))

    times = {}
    for tag, _, fn, n_bytes in rows:
        times[tag] = {"ms": cs.cuda_ms(fn, ITERS), "host_us": _host_us(fn),
                      "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}
    for tag, keys, fn, _ in rows:  # every profiler session after every other time
        t = times[tag]
        t["kernel_only_ms"] = cs.kernel_device_ms(fn, keys, iters=ITERS)
        print(f"{tag}: call {t['ms']:.4f} ms, host {t['host_us']:.1f} us per call, kernel alone "
              f"{t['kernel_only_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms", flush=True)
    result = {"card": card, "times": times}
    if args.save:
        torch.save(outputs, args.save)
    if args.compare:
        other = torch.load(args.compare)
        diff = {}
        for name, x in outputs.items():
            diff[name] = {"bit_for_bit": torch.equal(x, other[name]),
                          "max_abs_diff": float((x - other[name]).abs().max())}
            print(f"{name}: bit for bit with {args.compare}: {diff[name]['bit_for_bit']}; "
                  f"largest difference {diff[name]['max_abs_diff']:.3e}")
        result["compare"] = diff
    print(json.dumps(result))


if __name__ == "__main__":
    main()
