#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from; the benchmark's own
runs do not run this.

    python3 nerfbench/calibrate.py --workload <cell> --seeds 11 12 ... [--control float8_e4m3fn]

For each seed, in one process: the program's readings (the cell's numbers
of the program against the float32 reference, as a run compares them) and
the control's (the reference computed in the control's precision, put in
the program's place, against the float32 reference).  A training cell adds
the fault "half of the batch left out, the mean taken over the rest",
planted in the reference put in the program's place.  An eval cell renders
``--frames`` frames per seed.  Prints one JSON line per seed and reading.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def half_feeds(feeds):
    """Each batch and its draws cut to their first half."""
    def cut(x):
        import torch

        if torch.is_tensor(x):
            return x[: x.shape[0] // 2] if x.ndim and x.shape[0] > 1 else x
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(cut(v) for v in x)
        return x

    return [dict(f, pixel=cut(f["pixel"]), lidar=cut(f["lidar"]),
                 pixel_draws=cut(f["pixel_draws"]), lidar_draws=cut(f["lidar_draws"]))
            for f in feeds]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default="float8_e4m3fn,float8_e5m2",
                    help="the control's forward and backward dtypes")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU")
    ap.add_argument("--detail", action="store_true",
                    help="a training cell's per-step losses and per-leaf norms too")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from nerfbench import harness
    from nerfbench.reference import compare

    harness.pin_caches(ROOT)
    dev = torch.device("cpu") if args.cpu else harness.check_chip(1)
    wl = harness.load_workload(args.workload)
    cfg = harness.load_json("configs", f"{wl['config']}.json")
    driver = harness.load_module("drivers", f"{wl['kind']}.py")
    control = tuple(getattr(torch, n) for n in args.control.split(","))
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = harness.Ctx(args.workload, wl, cfg, seed, 0.0, False, dev, t0)
        if wl["kind"] == "train":
            q = float(wl["grad_diff_quantile"])
            s = driver.compared_setup(ctx)
            del s["trainer"]
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            t1 = time.perf_counter()
            ref = compare.follow_train(cfg, wl, s["facts"], s["names"], seed, dev, s["feeds"])
            t2 = time.perf_counter()
            readings = {"program": compare.train_numbers(s["prog"], ref, q)}
            leaves = {"program": compare.diff_gaps(s["prog"]["grad_sum"], ref["grad_sum"])}
            low = compare.follow_train(cfg, wl, s["facts"], s["names"], seed, dev, s["feeds"],
                                       round_dtype=control)
            readings["control"] = compare.train_numbers(low, ref, q)
            leaves["control"] = compare.diff_gaps(low["grad_sum"], ref["grad_sum"])
            del low
            half = compare.follow_train(cfg, wl, s["facts"], s["names"], seed, dev,
                                        half_feeds(s["feeds"]))
            readings["half_batch"] = compare.train_numbers(half, ref, q)
            leaves["half_batch"] = compare.diff_gaps(half["grad_sum"], ref["grad_sum"])
            del half
            extra = {"feed_check": s["reasons"], "ref_s": t2 - t1,
                     "grad_diff_leaves": {k: v.tolist() for k, v in leaves.items()}}
            if args.detail:
                extra["detail"] = {"names": s["names"], **{
                    side: {k: v[k] for k in ("losses", "grad", "change")}
                    for side, v in (("program", s["prog"]), ("reference", ref))}}
        else:
            ctx.seconds = 0.0
            samples, names, facts = driver.sampled_frames(ctx, args.frames)
            t1 = time.perf_counter()
            ref = compare.follow_eval(cfg, wl, facts, names, seed, dev, samples)
            t2 = time.perf_counter()
            low = compare.follow_eval(cfg, wl, facts, names, seed, dev, samples,
                                      round_dtype=control)
            readings = {"program": compare.eval_numbers(samples, ref),
                        "control": compare.eval_numbers(
                            [dict(s, maps=l) for s, l in zip(samples, low)], ref)}
            extra = {"ref_s": t2 - t1, "frames": len(samples)}
        print(json.dumps({"seed": seed, "readings": readings, "seconds":
                          time.perf_counter() - t0, **extra}), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
