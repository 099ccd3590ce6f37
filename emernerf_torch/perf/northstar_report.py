#!/usr/bin/env python
"""Summarize one training run of the port into a markdown report (a copy of
the repository's ``perf/northstar_report.py``): training curve milestones
from the run's metrics.json (JSON-lines), final eval metric files, artifact
inventory (checkpoints / videos / buffer maps), and wall-clock accounting.

One difference from the original: the report is written into the run
directory (``<run>/NORTHSTAR_<run-dir-basename>.md``), never next to this
module, so that a run writes nothing into the package.  The training CLI
(``emernerf_torch/train_emernerf.py``) writes it after the end-of-training
evaluation and after ``--eval_only``.

Usage: python -m emernerf_torch.perf.northstar_report RUN_DIR [--out OUT.md]
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def build_report(run: str) -> str:
    lines = [f"# North-star flagship run: `{run}`", ""]

    # training curve from JSON-lines metrics.json
    mpath = os.path.join(run, "metrics.json")
    curve = []
    if os.path.exists(mpath):
        with open(mpath) as f:
            for ln in f:
                try:
                    curve.append(json.loads(ln))
                except json.JSONDecodeError:
                    pass
    steps = [c for c in curve if "psnr" in c and "iteration" in c]
    if steps:
        lines += ["## Training curve (smoothed meters at print_freq)", "",
                  "| step | psnr | range_rmse | rgb_loss | s/step |",
                  "|---|---|---|---|---|"]
        # ~12 milestones derived from the iterations actually present,
        # plus always the last row
        idx = sorted({round(i * (len(steps) - 1) / 11) for i in range(12)})
        for j in idx:
            c = steps[j]
            t = c.get("iter_time")
            lines.append(
                f"| {c['iteration']} | {c.get('psnr', float('nan')):.2f} | "
                f"{c.get('range_rmse', float('nan')):.3f} | "
                f"{c.get('rgb_loss', float('nan')):.4f} | "
                f"{t:.3f} |" if t is not None else
                f"| {c['iteration']} | {c.get('psnr', float('nan')):.2f} | "
                f"{c.get('range_rmse', float('nan')):.3f} | "
                f"{c.get('rgb_loss', float('nan')):.4f} | - |")
        lines.append("")

    # final eval metric jsons
    for pat, title in (("metrics_all_*.json", "Final evaluation"),
                       ("metrics_test_*.json", "Test-split eval"),
                       ("metrics_lowres_*.json", "Low-res eval"),
                       ("metrics_full_*.json", "Full-res eval")):
        for p in sorted(glob.glob(os.path.join(run, pat))):
            with open(p) as f:
                d = json.load(f)
            lines += [f"## {title} (`{os.path.basename(p)}`)", ""]
            for k, v in d.items():
                lines.append(f"- {k}: {v:.4f}" if isinstance(v, float)
                             else f"- {k}: {v}")
            lines.append("")

    # artifact inventory
    lines += ["## Artifacts", ""]
    for sub in ("checkpoint_*", "lowres_videos/*", "full_videos/*",
                "videos/*", "buffer_maps/*", "images/*", "test_videos/*",
                "metrics_*.json", "voxels.*", "scene_flow.*"):
        hits = sorted(glob.glob(os.path.join(run, sub)))
        if hits:
            lines.append(f"- {sub}: {len(hits)} "
                         f"({', '.join(os.path.basename(h) for h in hits[:4])}"
                         f"{', ...' if len(hits) > 4 else ''})")
    lines.append("")
    return "\n".join(lines)


def write_report(run: str, out: str | None = None) -> str:
    """Build + write the report (by default into the run directory);
    returns the output path."""
    if out is None:
        base = os.path.basename(os.path.normpath(run)) or "run"
        out = os.path.join(run, f"NORTHSTAR_{base}.md")
    text = build_report(run)
    with open(out, "w") as f:
        f.write(text)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = write_report(args.run, args.out)
    with open(out) as f:
        print(f.read())
    print(f"[northstar_report] wrote {out}")


if __name__ == "__main__":
    main()
