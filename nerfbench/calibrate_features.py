#!/usr/bin/env python3
"""``calibrate.py``'s training readings for a cell of the ``train_features``
kind (``drivers/train_features.py``), ``dino_feat`` among them; the
benchmark's own runs do not run this.

    python3 nerfbench/calibrate_features.py --workload feature-train --seeds 11 12 ... [--detail]

For each seed, in one process: the program's readings, the control's (the
reference computed in fp8, e4m3 forward and e5m2 backward, in the
program's place) and the half batch's (``calibrate.py``'s fault), each
against the float32 reference.  The half batch renders half the rays, so
its ``dino_feat`` is read over the rays it shares with the reference.
Prints one JSON line per seed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU")
    ap.add_argument("--detail", action="store_true",
                    help="the per-step losses and per-leaf norms too")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from nerfbench import harness
    from nerfbench.calibrate import half_feeds
    from nerfbench.reference import compare

    harness.pin_caches(ROOT)
    dev = torch.device("cpu") if args.cpu else harness.check_chip(1)
    wl = harness.load_workload(args.workload)
    cfg = harness.load_json("configs", f"{wl['config']}.json")
    drv = harness.load_module("drivers", f"{wl['kind']}.py")
    q = float(wl["grad_diff_quantile"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        s = drv.compared_setup(harness.Ctx(args.workload, wl, cfg, seed, 0.0, False, dev, t0))
        del s["trainer"]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        fed = (cfg, wl, s["facts"], s["names"], seed, dev)
        ref = drv.follow_train(*fed, s["feeds"])
        sides = {"program": s["prog"],
                 "control": drv.follow_train(*fed, s["feeds"], round_dtype=(
                     torch.float8_e4m3fn, torch.float8_e5m2))}
        half = drv.follow_train(*fed, half_feeds(s["feeds"]))
        n = next(iter(half["dino_feat"].values())).shape[0]
        ref_half = dict(ref, dino_feat={k: v[:n] for k, v in ref["dino_feat"].items()})
        readings = {k: drv.numbers(v, ref, q) for k, v in sides.items()}
        readings["half_batch"] = drv.numbers(half, ref_half, q)
        out = {"seed": seed, "readings": readings, "feed_check": s["reasons"],
               "grad_diff_leaves": {k: compare.diff_gaps(v["grad_sum"], ref["grad_sum"]).tolist()
                                    for k, v in dict(sides, half_batch=half).items()}}
        if args.detail:
            out["detail"] = {"names": s["names"], **{
                side: {k: v[k] for k in ("losses", "grad", "change")}
                for side, v in (("program", s["prog"]), ("reference", ref))}}
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del s, ref, sides, half
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
