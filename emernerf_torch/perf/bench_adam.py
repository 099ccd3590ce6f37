#!/usr/bin/env python
"""Times K11, the data-parallel Adam (``train/optim.py``: the replicated
update, the ZeRO slab step, the gathered direction's update), at the
full-width flagship's shapes, the same calls ``chip_smoke.py`` phase 17c
checks: the replicated update over every parameter and over the leaves the
ZeRO layout of two ranks keeps replicated (the model's and the proposal
nets' groups, as the train step calls it); the slab step over rank 0's
halves of the routed tables, bf16 and fp32 wire (bf16 moments and
direction); the gathered direction over the routed tables (bf16) and the
fused grid (fp32).  Each row gives the median CUDA-event time of one call
(``ms``), the device time per call with the host ahead of the card
(``queued_ms``: calls queued behind a sleep kernel), the bound (the bytes
the call must move over the HBM rate) and the library call where one
exists (fused ``torch.optim.Adam`` with fp32 moments; ``p.add_(dir,
alpha=-lr)``).

It calls the update the way its checkout's ``train/optim.py`` offers it:
one call with every leaf of a group where ``spmd_adam_update`` takes
lists, else one call per leaf; so the same file times another checkout of
the port when copied into it.  ``--save F`` writes checksums of every
output, ``--compare F`` holds them to another checkout's.  Run it from a
checkout's root:

    python -m emernerf_torch.perf.bench_adam [--save F | --compare F]

The last line is one JSON object of the times with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

ITERS = 10
N_RANKS = 2


def checksum(t: torch.Tensor):
    """(float64 sum, int64 sum of the raw bits): equal outputs, equal sums."""
    bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    return [float(t.double().sum()), int(bits.sum(dtype=torch.int64))]


def main(argv=None):
    import chip_smoke as cs
    from emernerf_torch.flagship import build_flagship
    from emernerf_torch.parallel.spmd import SpmdConfig, routing, transposed_params
    from emernerf_torch.train import optim

    ap = argparse.ArgumentParser()
    ap.add_argument("--save")
    ap.add_argument("--compare")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_adam: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    multi = hasattr(optim, "SPMD_LEAVES_PER_LAUNCH")
    g = torch.Generator(device=dev).manual_seed(17)
    _, _, model, props, _ = build_flagship(device=dev, seed=0)
    model_params = [p.detach() for p in model.parameters()]
    params = model_params + [p.detach() for m in props for p in m.parameters()]
    route = routing(params, transposed_params(model, *props), SpmdConfig(zero=True), N_RANKS)
    del model, props
    adam = optim.make_adam(1e-5)
    h = adam.hyper(4, 0.005)
    mom = adam.init(params)
    for m_, v_ in zip(mom.mu, mom.nu):
        m_.copy_(torch.randn(m_.shape, device=dev, generator=g) * 1e-3)
        v_.copy_(torch.rand(v_.shape, device=dev, generator=g) * 1e-6)
    grads = [torch.randn(p.shape, device=dev, generator=g) * 1e-3 for p in params]
    times, sums = {}, {}

    def row(name, fn, n_bytes, outs, library=None):
        fn()
        torch.cuda.synchronize()
        sums[name] = [checksum(t) for t in outs]
        r = dict(ms=cs.cuda_ms(fn, ITERS), queued_ms=cs.queued_ms(fn, ITERS),
                 bound_ms=cs.bound(n_bytes, 0.0)[0],
                 library_ms=None if library is None else cs.cuda_ms(library, ITERS))
        times[name] = r
        print(f"{name}: {r['ms']:.4f} ms, queued {r['queued_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%})"
              + ("" if library is None else f", library {r['library_ms']:.4f} ms"), flush=True)

    # the replicated update: every parameter, then the ZeRO layout's groups
    n_model = len(model_params)
    rep = [i for i, big in enumerate(route.big) if not big]
    for what, parts in (("every parameter", [list(range(len(params)))]),
                        ("replicated leaves", [[i for i in rep if i < n_model],
                                               [i for i in rep if i >= n_model]])):
        leaves = [i for part in parts for i in part]
        ps, ms_, vs = ([x[i].clone() for i in range(len(params))]
                       for x in (params, mom.mu, mom.nu))

        def update(ps=ps, ms_=ms_, vs=vs, parts=parts):
            for part in parts:
                if multi:
                    optim.spmd_adam_update([ps[i] for i in part], [grads[i] for i in part],
                                           [ms_[i] for i in part], [vs[i] for i in part], h)
                else:
                    for i in part:
                        optim.spmd_adam_update(ps[i], grads[i], ms_[i], vs[i], h)

        lib = [params[i].clone() for i in leaves]
        for p, i in zip(lib, leaves):
            p.grad = grads[i]
        lib_opt = torch.optim.Adam(lib, lr=-h.neg_lr, betas=(0.9, 0.99), eps=1e-15,
                                   weight_decay=1e-5, fused=True)
        n_bytes = sum(cs.nbytes(params[i], grads[i], mom.mu[i], mom.nu[i])
                      + cs.nbytes(params[i], mom.mu[i], mom.nu[i]) for i in leaves)
        row(f"spmd_adam_update[{what}: {len(leaves)} tensors]", update, n_bytes,
            [x[i] for x in (ps, ms_, vs) for i in leaves], lib_opt.step)
        del ps, ms_, vs, lib, lib_opt
        torch.cuda.empty_cache()
    del grads

    # the slab step over rank 0's halves of the routed tables
    big = [i for i, b in enumerate(route.big) if b]
    slabs = [params[i][:params[i].shape[0] // N_RANKS] for i in big]
    dirs = []
    for wire in (torch.bfloat16, torch.float32):
        ins = [((torch.randn(s.shape, device=dev, generator=g) * 1e-2).to(wire),
                (torch.randn(s.shape, device=dev, generator=g) * 1e-3).bfloat16(),
                (torch.rand(s.shape, device=dev, generator=g) * 1e-6).bfloat16()) for s in slabs]
        outs = [torch.empty(s.shape, dtype=torch.bfloat16, device=dev) for s in slabs]

        def slab_step(ins=ins, outs=outs):
            for s, (w, m_, v_), d in zip(slabs, ins, outs):
                optim.zero_slab_update(w, s, m_, v_, d, N_RANKS, h)

        n_bytes = sum(cs.nbytes(w, s, m_, v_) + cs.nbytes(m_, v_, d)
                      for s, (w, m_, v_), d in zip(slabs, ins, outs))
        row(f"zero_slab_update[{len(slabs)} slabs, wire {str(wire)[6:]}]", slab_step, n_bytes,
            [t for w_m_v in ins for t in w_m_v[1:]] + outs)
        dirs = outs
        del ins
        torch.cuda.empty_cache()

    # the gathered direction: bf16 over the routed tables, fp32 over the fused grid
    fused = max(range(len(big)), key=lambda j: params[big[j]].numel())
    fp32_dir = torch.randn(params[big[fused]].shape, device=dev, generator=g) * 1e-3
    for what, targets, full in (
            ("bf16 over the routed tables", [params[i] for i in big],
             [torch.cat([d] * N_RANKS) for d in dirs]),
            ("fp32 over the fused grid", [params[big[fused]]], [fp32_dir])):
        ps = [p.clone() for p in targets]
        lib = [p.clone() for p in targets]

        def apply(ps=ps, full=full):
            for p, d in zip(ps, full):
                optim.apply_direction(p, d, h.neg_lr)

        def library(lib=lib, full=full):
            for p, d in zip(lib, full):
                p.add_(d, alpha=h.neg_lr)

        n_bytes = sum(cs.nbytes(p, d) + cs.nbytes(p) for p, d in zip(targets, full))
        row(f"apply_direction[{what}]", apply, n_bytes, ps, library)
        del ps, lib, full
        torch.cuda.empty_cache()

    if args.save:
        with open(args.save, "w") as f:
            json.dump(sums, f)
    if args.compare:
        with open(args.compare) as f:
            theirs = json.load(f)
        differ = [k for k in sums if k in theirs and sums[k] != theirs[k]]
        print(f"outputs against {args.compare}: {len(set(sums) & set(theirs))} rows compared, "
              f"{'every one equal' if not differ else 'DIFFER: ' + ', '.join(differ)}")
        if differ:
            raise SystemExit(1)
    print(json.dumps({"card": card, "multi_leaf": multi, "times": times}))


if __name__ == "__main__":
    main()
