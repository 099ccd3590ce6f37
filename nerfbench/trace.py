"""What a traced run reads from the program: the device's kernels over a
short profiled span (``torch.profiler``, CUDA activity only), and the grid
calls of that span, recorded by a wrapper around the port's public
``grid_encode`` as the fields look it up.  Spans inside the program are
for a later change; the benchmark reads only kernel names and the grid
calls' arguments."""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import torch

TOP = 10  # entries of each breakdown list


class GridRecorder:
    """Inside ``with``: every field grid call's spec, positions (kept, not
    copied: no kernel is added to the span), whether it runs a backward
    (grad mode on and the table or the positions need a gradient) and
    whether the positions get one."""

    def __init__(self):
        self.calls: List[Dict[str, Any]] = []

    def __enter__(self):
        from emernerf_torch.models import fields

        self._fields = fields
        self._orig = fields.grid_encode

        def recorded(table, positions, spec, compute_dtype=None):
            grad = torch.is_grad_enabled()
            self.calls.append(dict(
                spec=spec, positions=positions,
                backward=grad and (table.requires_grad or positions.requires_grad),
                pos_grad=grad and positions.requires_grad,
                table_bytes=table.element_size(),
                compute_bytes=torch.empty((), dtype=compute_dtype or table.dtype).element_size()))
            return self._orig(table, positions, spec, compute_dtype)

        fields.grid_encode = recorded
        return self

    def __exit__(self, *exc):
        self._fields.grid_encode = self._orig
        return False


def profile_span(fn: Callable[[], Any], device) -> Dict[str, Any]:
    """Runs ``fn`` under the profiler (CUDA activity only) and returns its
    kernels: per name the device seconds and launches, the merged busy
    seconds, the span's wall seconds and the idle gaps between kernels."""
    from torch.profiler import ProfilerActivity, profile

    from nerfbench.program import sync

    # a CPU rehearsal profiles the CPU's operators in the card's place
    kind = "CUDA" if device.type == "cuda" else "CPU"
    sync(device)
    prof = profile(activities=[getattr(ProfilerActivity, kind)])
    prof.start()
    t0 = time.perf_counter()
    fn()
    sync(device)
    wall = time.perf_counter() - t0
    prof.stop()
    spans = []
    for e in prof.events():
        if getattr(e, "device_type", None) is None or kind not in str(e.device_type):
            continue
        tr = e.time_range
        if tr.end > tr.start:
            spans.append((tr.start * 1e-6, tr.end * 1e-6, e.name))
    spans.sort()
    kernels: Dict[str, List[float]] = {}
    for s, e, name in spans:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += e - s
        k[1] += 1
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    last = ""
    for s, e, name in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, last))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last = name
    if cur_e is not None:
        busy += cur_e - cur_s
    return {"kernels": {n: (t, c) for n, (t, c) in kernels.items()}, "busy_s": busy,
            "wall_s": wall, "gaps": gaps, "launches": len(spans)}


def kernel_seconds(span: Dict[str, Any], *needles: str) -> float:
    """Device seconds of the span's kernels whose name holds any needle."""
    return sum(t for n, (t, _) in span["kernels"].items() if any(k in n for k in needles))


def breakdown(span: Dict[str, Any]) -> Dict[str, list]:
    """The top device operations by time and the longest idle gaps, named
    by the kernel after which the device waited for the host."""
    ops = sorted(((n[:120], t) for n, (t, _) in span["kernels"].items()), key=lambda x: -x[1])
    gaps: Dict[str, float] = {}
    for g, after in span["gaps"]:
        key = f"after {after[:110]}"
        gaps[key] = max(gaps.get(key, 0.0), g)
    longest = sorted(gaps.items(), key=lambda x: -x[1])
    return {"device_ops": [[n, t] for n, t in ops[:TOP]],
            "idle_gaps": [[n, g] for n, g in longest[:TOP]]}


def resolve_grid_calls(tr: Dict[str, Any]) -> None:
    """Each recorded grid call's least time (``counts/grids.py``), its
    positions dropped: the readers read numbers only."""
    from nerfbench.counts import grids

    out = []
    for c in tr["grid_calls"]:
        spec = grids.frozen_spec(c["spec"])
        pos = c["positions"]
        n = pos.numel() // spec.n_input_dims
        touched = grids.touched(spec, pos.detach())
        rec = dict(brick=grids.is_brick(spec), n=n, touched=touched, backward=c["backward"],
                   pos_grad=c["pos_grad"])
        args = (spec, n, touched)
        rec["forward_s"] = grids.least_seconds(*args, False, False, c["table_bytes"],
                                               c["compute_bytes"])
        rec["backward_s"] = (grids.least_seconds(*args, True, c["pos_grad"], c["table_bytes"],
                                                 c["compute_bytes"]) if c["backward"] else 0.0)
        out.append(rec)
    tr["grid_calls"] = out
