"""The program's spans in a traced run (``emernerf_torch/utils/trace.py``):
what the host was doing while the device waited.

``install()`` wraps ``trace.profile_span`` and ``trace.breakdown``; the
per-layer readers that read spans call it when they are loaded, which the
harness does only for a traced run, before the driver runs.  The wrapped
``profile_span`` turns the program's spans on around the profiled span
(never ``annotate``: no profiler event is added, so every field the
unwrapped one returns reads the same) and adds to what it returns:

- ``spans``: the program's records, on the profiler's clock;
- ``intervals_ns``: each device operation's (start, end, name) on that
  clock (Kineto's ``trace_start_ns`` plus the event's relative stamps);
- ``gap_spans``: beside each of ``gaps``, the span that holds most of that
  idle gap, or None;
- ``idle_by_span``: the profiled span's idle seconds (``wall_s`` less
  ``busy_s``) per unit (iteration, frame), by the innermost span open
  during each part of each idle interval; whatever idle no named span
  holds (outside every span, or outside the spans' first opening and last
  close) is ``untraced``, so idle the split cannot place is not lost.

It prints the spans' host ms per unit, ``idle_by_span``, the share of the
idle in a named span and where the device's operations lie against the
spans' window on standard error.  The wrapped ``breakdown`` names each idle
gap ``<span> after <kernel>``, the span first.  A program without spans (no
``emernerf_torch.utils.trace``) is profiled as before, and the readers read
None.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

from nerfbench import trace

UNTRACED = "untraced"


def install() -> None:
    """Wraps ``trace.profile_span`` and ``trace.breakdown`` (once)."""
    if getattr(trace.profile_span, "spans_installed", False):
        return
    unwrapped_profile, unwrapped_breakdown = trace.profile_span, trace.breakdown

    def profile_span(fn: Callable[[], Any], device) -> Dict[str, Any]:
        return _profile_span(unwrapped_profile, fn, device)

    def breakdown(span: Dict[str, Any]) -> Dict[str, list]:
        out = unwrapped_breakdown(span)
        if "gap_spans" in span:
            out["idle_gaps"] = named_gaps(span)
        return out

    profile_span.spans_installed = True
    profile_span.unwrapped = unwrapped_profile
    trace.profile_span, trace.breakdown = profile_span, breakdown


def _profile_span(unwrapped, fn, device) -> Dict[str, Any]:
    try:
        from emernerf_torch.utils import trace as program_trace
    except ImportError:  # a program without spans
        return unwrapped(fn, device)
    import torch.profiler

    profilers = []
    plain = torch.profiler.profile

    class Kept(plain):
        """The profiler the unwrapped ``profile_span`` makes, kept for its
        clock and events."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            profilers.append(self)

    window: Dict[str, Any] = {}

    def traced():
        program_trace.enable()
        window["t0"] = time.time_ns()
        try:
            fn()
        finally:
            window["t1"] = time.time_ns()
            window["records"] = program_trace.disable()

    torch.profiler.profile = Kept
    try:
        sp = unwrapped(traced, device)
    finally:
        torch.profiler.profile = plain
    prof = profilers[-1]
    kind = "CUDA" if device.type == "cuda" else "CPU"
    sp["intervals_ns"] = device_intervals(prof, kind)
    sp["spans"] = window["records"]
    units = max(sum(r.parent == 0 for r in sp["spans"]), 1)
    t0, t1 = window["t0"], window["t1"]
    idle, gap_spans = split_idle(sp["intervals_ns"], sp["spans"], t0, t1)
    if len(gap_spans) == len(sp["gaps"]):  # else the gaps keep their names
        sp["gap_spans"] = gap_spans
    total = sp["wall_s"] - sp["busy_s"]
    sp["idle_by_span"] = {n: s / units for n, s in by_span(idle, total).items()}
    print("nerfbench: " + report(sp, units), file=sys.stderr)
    print("nerfbench: " + placement(sp["intervals_ns"], t0, t1, sum(idle.values()), total),
          file=sys.stderr)
    return sp


def device_intervals(prof, kind: str) -> List[Tuple[int, int, str]]:
    """The device operations the unwrapped ``profile_span`` reads, each as
    (start, end, name) in ns on ``time.time_ns()``'s clock, by start."""
    t0 = prof.profiler.kineto_results.trace_start_ns()
    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) is None or kind not in str(e.device_type):
            continue
        tr = e.time_range
        if tr.end > tr.start:
            out.append((t0 + round(tr.start * 1e3), t0 + round(tr.end * 1e3), e.name))
    out.sort()
    return out


def _innermost(records, t0: int, t1: int) -> List[Tuple[int, int, str]]:
    """[t0, t1] cut into (start, end, name) pieces, each named by the
    innermost span open over it (``untraced`` outside every span)."""
    kids: Dict[int, list] = defaultdict(list)
    for r in records:
        kids[r.parent].append(r)
    for v in kids.values():
        v.sort(key=lambda r: r.start_ns)
    out = []

    def walk(parent_id: int, name: str, a: int, b: int):
        t = a
        for r in kids.get(parent_id, ()):
            s, e = max(r.start_ns, t), min(r.end_ns, b)
            if e <= s:
                continue
            if s > t:
                out.append((t, s, name))
            walk(r.id, r.name, s, e)
            t = e
        if b > t:
            out.append((t, b, name))

    walk(0, UNTRACED, t0, t1)
    return out


def idle_intervals(intervals, t0: int, t1: int) -> List[Tuple[int, int, Optional[str]]]:
    """The device's idle stretches within [t0, t1]: between merged
    operation intervals (each with the name of the operation started last
    before it, as ``trace.profile_span`` names its ``gaps``), and before the
    first and after the last (named None)."""
    out = []
    cur_e, last = None, None
    for s, e, name in intervals:
        if cur_e is None:
            if s > t0:
                out.append((t0, s, None))
            cur_e = e
        elif s > cur_e:
            out.append((cur_e, s, last))
            cur_e = e
        else:
            cur_e = max(cur_e, e)
        last = name
    if cur_e is None:
        out.append((t0, t1, None))
    elif t1 > cur_e:
        out.append((cur_e, t1, None))
    return out


def split_idle(intervals, records, t0: int, t1: int):
    """(idle seconds by the innermost span, the span holding most of each
    gap between operations, in ``trace.profile_span``'s order of
    ``gaps``)."""
    pieces = _innermost(records, t0, t1)
    idle: Dict[str, float] = defaultdict(float)
    gap_spans: List[Optional[str]] = []
    i = 0
    for a, b, after in idle_intervals(intervals, t0, t1):
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        held: Dict[str, int] = defaultdict(int)
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            ov = min(b, pieces[j][1]) - max(a, pieces[j][0])
            if ov > 0:
                held[pieces[j][2]] += ov
            j += 1
        for name, ns in held.items():
            idle[name] += ns * 1e-9
        if after is not None:
            top = max(held, key=held.get) if held else UNTRACED
            gap_spans.append(None if top == UNTRACED else top)
    return dict(idle), gap_spans


def by_span(idle: Dict[str, float], total_s: float) -> Dict[str, float]:
    """The named spans' idle seconds from ``split_idle``, and as
    ``untraced`` the rest of the profiled span's idle ``total_s``."""
    out = {n: s for n, s in idle.items() if n != UNTRACED}
    out[UNTRACED] = total_s - sum(out.values())
    return out


def placement(intervals, t0: int, t1: int, split_s: float, total_s: float) -> str:
    """Where the device's operations lie against the spans' window [t0, t1]
    (ns), and how much of the profiled span's idle the split placed: a
    shortfall beyond the moments before ``t0`` and after ``t1`` shows a
    clock that the operations' stamps and the spans do not share."""
    if not intervals:
        return "spans' window: no device operation"
    first, last = intervals[0][0], max(e for _, e, _ in intervals)
    inside = sum(min(e, t1) - max(s, t0) for s, e, _ in intervals if min(e, t1) > max(s, t0))
    return (f"spans' window {1e-6 * (t1 - t0):.3f} ms; {len(intervals)} device operations, "
            f"the first at its start {1e-6 * (first - t0):+.3f} ms, the last ending at its end "
            f"{1e-6 * (last - t1):+.3f} ms, {1e-6 * inside:.3f} ms of them inside it (unmerged); "
            f"idle {1e3 * total_s:.3f} ms, {1e3 * split_s:.3f} ms of it placed in the window")


def named_gaps(span: Dict[str, Any]) -> List[list]:
    """``breakdown``'s idle gaps, each named by the span that holds most of
    it before the kernel after which the device waited."""
    longest: Dict[str, float] = {}
    for (g, after), where in zip(span["gaps"], span["gap_spans"]):
        key = f"after {after[:110]}" if where is None else f"{where} after {after[:110]}"
        longest[key] = max(longest.get(key, 0.0), g)
    top = sorted(longest.items(), key=lambda x: -x[1])[:trace.TOP]
    return [[n, g] for n, g in top]


def host_s_by_name(records) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(total, self) seconds of the spans by name: a span's self time is
    its duration less its children's."""
    total: Dict[str, float] = defaultdict(float)
    child: Dict[int, int] = defaultdict(int)
    for r in records:
        total[r.name] += (r.end_ns - r.start_ns) * 1e-9
        child[r.parent] += r.end_ns - r.start_ns
    own: Dict[str, float] = defaultdict(float)
    for r in records:
        own[r.name] += (r.end_ns - r.start_ns - child[r.id]) * 1e-9
    return dict(total), dict(own)


def report(sp: Dict[str, Any], units: int) -> str:
    """One line: the spans' host ms (total and self) and the idle ms by
    span, each per unit."""
    total, own = host_s_by_name(sp["spans"])

    def ms(d, per=units):
        return {k: round(1e3 * v / per, 3) for k, v in sorted(d.items())}

    idle = sum(sp["idle_by_span"].values())  # the profiled span's idle a unit
    named = idle - sp["idle_by_span"].get(UNTRACED, 0.0)
    return (f"spans: {units} units, profiled span {1e3 * sp['wall_s'] / units:.3f} ms a unit; "
            f"host ms a unit by span {ms(total)}; self {ms(own)}; idle ms a unit by span "
            f"{ms(sp['idle_by_span'], 1)} (in a named span: "
            f"{100 * named / idle if idle > 0 else 0.0:.1f}%)")


def host_ms_per_unit(tr, kind: str, name: str, under: str = "") -> Optional[float]:
    """Host ms per unit of the traced run in the spans named ``name`` (with
    ``under``, only those inside a span whose name starts with it); None
    where the run recorded no such span."""
    if tr is None or tr["kind"] != kind:
        return None
    records = tr["span"].get("spans")
    if not records:
        return None
    by_id = {r.id: r for r in records}

    def inside(r) -> bool:
        while r.parent:
            r = by_id[r.parent]
            if r.name.startswith(under):
                return True
        return False

    picked = [r for r in records if r.name == name and (not under or inside(r))]
    if not picked:
        return None
    return 1e3 * sum(r.end_ns - r.start_ns for r in picked) * 1e-9 / tr["units"]
