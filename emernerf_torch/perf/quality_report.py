#!/usr/bin/env python
"""Summarize the port's quality rows (``quality_ab.py``'s
``QUALITY_h100.json``; the counterpart of the repository's
``perf/quality_report.py``): each row's dB delta against its base at the
largest common step, by the original's base rules (``R3_VARIANTS``,
``BASE_OVERRIDE``, ``PAIR_BASES``, ``defaults_era``), its speed against
the base's (port rows only), and a column against the JAX record's row of
the same name (``--reference``, default ``perf/QUALITY_r02.json``, read as
data) at their largest common step: the PSNR and range RMSE there, and the
largest |PSNR gap| over the common records from ``CURVE_FROM`` on.  No
time of the JAX record is printed.  A row of another seed
(``<variant>/seed<N>``) or with settings on top (``quality_ab.py
--with``) takes its variant's row as its base; a seed row also takes its
variant's JAX row.

Where the original would skip a row (its base is not among the rows, or it
is a pair's base), this one prints it without the base columns: the port
records few variants, and each still has a JAX row to stand beside.

Usage: python -m emernerf_torch.perf.quality_report [--results F]
       [--reference F] [--json OUT]
"""

from __future__ import annotations

import argparse
import json
import os

_HERE = os.path.dirname(os.path.abspath(__file__))
RESULTS = os.path.join(_HERE, "QUALITY_h100.json")
REFERENCE = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "perf", "QUALITY_r02.json")

# recorded on pruning-on defaults -> base is the stopk32l16 curve
R3_VARIANTS = {"hash", "refsem", "refsembrick", "stagedl16", "nofuse",
               "timepair0", "onehot0", "lprop6432", "prop6432",
               "mx", "mxr8", "mxr32", "brick4k", "hash4k", "refsembrick4k"}

# matched pairs measured against each other, not the default curve
BASE_OVERRIDE = {"hash4k": "brick4k", "refsembrick4k": "brick4k",
                 "refsem4k2500": "brick4k2500"}

# anchors of matched pairs: a quarter-batch run is not held against the
# full-batch default curve
PAIR_BASES = {"brick4k", "brick4k2500"}

GATE_DB = 0.3  # the repository's quality gate, |d PSNR|
CURVE_FROM = 1000  # the JAX column's curve gap counts the records from this step on


def _ms(v):
    """Steady-state step time if recorded; legacy ms_per_step otherwise;
    None when timing is missing."""
    return v.get("steady_ms_per_step") or v.get("ms_per_step") \
        or v.get("wall_ms_per_step_incl_compile")


def base_of(name, v):
    """The base row name of row ``name`` by the original's rules."""
    if name in BASE_OVERRIDE:
        return BASE_OVERRIDE[name]
    if v.get("defaults_era") == "staged" and name != "stagedl16":
        return "stagedl16"
    return "stopk32l16" if name in R3_VARIANTS else "base"


def variant_of(name, v):
    """The variant a row ran: its own name, or for a row of another seed or
    with settings on top (quality_ab's ``--seed``, ``--with``) the
    variant's."""
    return v.get("variant") or name.split("/seed")[0]


def _vs_base(name, v, d):
    """The original's columns against the base, or None where it skips; a
    row of another seed or with settings on top takes its variant's row."""
    own = variant_of(name, v)
    base_name = own if own != name else base_of(name, v)
    if (own == name and name in PAIR_BASES) or base_name not in d:
        return None
    base = d[base_name]
    base_curve = {c["step"]: c for c in base["curve"]}
    common = max((s for s in base_curve if s <= v["curve"][-1]["step"]), default=None)
    if common is None:
        return None
    vc = {c["step"]: c for c in v["curve"]}.get(common)
    if vc is None:
        return None
    b = base_curve[common]
    ms, base_ms = _ms(v), _ms(base)
    speed = round(base_ms / ms, 3) if (ms and base_ms) else None
    return {
        "base": base_name,
        "common_step": common,
        "psnr": vc["psnr"],
        "d_psnr_vs_base": round(vc["psnr"] - b["psnr"], 3),
        "range_rmse": vc["range_rmse"],
        "base_range_rmse": b["range_rmse"],
        "steady_ms_per_step": ms,
        "speedup_vs_base": speed,
        "within_0p3_db": bool(abs(vc["psnr"] - b["psnr"]) <= GATE_DB),
    }


def _vs_reference(v, ref):
    """The JAX row's columns at the largest common step, or {}."""
    if ref is None or not ref.get("curve"):
        return {}
    ours = {c["step"]: c for c in v["curve"]}
    theirs = {c["step"]: c for c in ref["curve"]}
    common = sorted(set(ours) & set(theirs))
    if not common:
        return {}
    s = common[-1]
    late = [abs(ours[k]["psnr"] - theirs[k]["psnr"]) for k in common if k >= CURVE_FROM]
    return {
        "jax_step": s,
        "jax_psnr": theirs[s]["psnr"],
        "psnr_at_jax_step": ours[s]["psnr"],
        "d_psnr_vs_jax": round(ours[s]["psnr"] - theirs[s]["psnr"], 3),
        "jax_range_rmse": theirs[s]["range_rmse"],
        "range_rmse_at_jax_step": ours[s]["range_rmse"],
        "max_abs_d_psnr_vs_jax_from_1000": round(max(late), 3) if late else None,
        "within_0p3_db_of_jax": bool(abs(ours[s]["psnr"] - theirs[s]["psnr"]) <= GATE_DB),
    }


def build_rows(d, reference=None):
    """One row per variant of ``d`` with a curve: the original's base
    columns (where it has them) and the JAX record's columns."""
    rows = {}
    for name, v in d.items():
        if not v["curve"]:
            continue
        row = _vs_base(name, v, d) or {
            "base": None, "psnr": v["curve"][-1]["psnr"],
            "range_rmse": v["curve"][-1]["range_rmse"], "steady_ms_per_step": _ms(v)}
        # a row of another seed beside its variant's JAX row; one with
        # settings on top beside none
        if not v.get("extra"):
            row.update(_vs_reference(v, (reference or {}).get(variant_of(name, v))))
        row["card"] = v.get("card")
        rows[name] = row
    return rows


def _f(x, fmt):
    return format(x, fmt) if x is not None else "-".rjust(len(format(0.0, fmt)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("--reference", default=REFERENCE)
    ap.add_argument("--json", default=None, help="write the rows to this file")
    args = ap.parse_args(argv)
    with open(args.results) as f:
        d = json.load(f)
    reference = None
    if args.reference and os.path.exists(args.reference):
        with open(args.reference) as f:
            reference = json.load(f)
    rows = build_rows(d, reference)
    w = max([14] + [len(n) + 1 for n in rows])
    print(f"{'variant':<{w}}{'base':<11}{'@step':>6}{'psnr':>8}{'d_psnr':>8}{'rmse':>7}"
          f"{'ms/step':>9}{'speed x':>8}{'@jax':>6}{'jax':>8}{'d_jax':>8}{'jax_rmse':>9}"
          f"{'max|d|':>8}")
    for name, r in rows.items():
        print(f"{name:<{w}}{r['base'] or '-':<11}{_f(r.get('common_step'), '>6')}"
              f"{r['psnr']:>8.2f}{_f(r.get('d_psnr_vs_base'), '>+8.2f')}"
              f"{r['range_rmse']:>7.2f}{_f(r.get('steady_ms_per_step'), '>9.1f')}"
              f"{_f(r.get('speedup_vs_base'), '>8.2f')}{_f(r.get('jax_step'), '>6')}"
              f"{_f(r.get('jax_psnr'), '>8.2f')}{_f(r.get('d_psnr_vs_jax'), '>+8.2f')}"
              f"{_f(r.get('jax_range_rmse'), '>9.2f')}"
              f"{_f(r.get('max_abs_d_psnr_vs_jax_from_1000'), '>8.2f')}")
    cards = sorted({r["card"] for r in rows.values() if r.get("card")})
    if cards:
        print("card: " + "; ".join(cards))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.json}")
    return rows


if __name__ == "__main__":
    main()
