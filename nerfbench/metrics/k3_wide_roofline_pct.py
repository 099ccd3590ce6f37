"""k3_wide_roofline_pct: K3's wide route (more than 64 value channels: the
feature head's composite) at its roofline, per profiled iteration, in %.

- Numerator: the least time (``counts/composite.py``) of every K3 call past
  64 channels in the profiled span, forward and backward.
- Denominator: the device time of the kernels those calls launched: each
  such forward's two (the weights with no value channels, then
  ``composite_sums_kernel``) and each such backward's ``composite_bwd_kernel``.

The wide route shares its kernels' names with the narrow calls: the
weights' kernel and ``composite_bwd_kernel<K, false>`` are one template
instance for 64-sample rays of any width, so a name alone does not tell a
wide call's launch from a narrow one's.  The recorder that this module
installs at import notes, in the profiled span only, every K3 call that
launches (R > 0) in the order the host makes it (``volrend._composite_forward``
and ``volrend.composite_along_rays_bwd``, wrapped for the span); on one stream
the device runs them in that order, so the n-th K3 forward (backward) launch
among the span's device operations is the n-th recorded forward (backward)
call's.  The device operations' intervals are those that ``nerfbench/spans.py``
adds to the span.

None where the span made no call past 64 channels (every configuration
without the feature head), where the device's K3 launches and the recorded
calls do not pair up (a record the profiler lost; also every CPU run, which
launches no kernel), or without the operations' intervals (a program
without spans).
"""

from __future__ import annotations

import re
import sys
from typing import Any, Dict, List, Optional

from nerfbench import spans, trace
from nerfbench.counts import composite

# the K3 launches, by the names the profiler records
_FORWARD = re.compile(r"\bcomposite_(?:warp_)?kernel\b")
_SUMS = "composite_sums_kernel"
_BACKWARD = "composite_bwd_kernel"


class CallRecorder:
    """Inside ``with``: every K3 call of the program that launches, in the
    host's order, as ``{r, s, d, c, backward, cotangents}``."""

    active = False

    def __init__(self):
        self.calls: List[Dict[str, Any]] = []

    def _note(self, t_starts, densities, chan_set, grads) -> None:
        r, s = t_starts.shape
        if r == 0:
            return
        call = dict(r=int(r), s=int(s), d=int(densities.shape[2]), c=len(chan_set),
                    backward=grads is not None)
        if grads is not None:
            call["cotangents"] = tuple(n for n, g in zip(composite.COTANGENTS, grads)
                                       if g is not None)
        self.calls.append(call)

    def __enter__(self):
        from emernerf_torch.render import volrend

        self._mod = volrend
        self._fwd, self._bwd = volrend._composite_forward, volrend.composite_along_rays_bwd

        def forward(t_starts, t_ends, densities, values, chan_set):
            self._note(t_starts, densities, chan_set, None)
            return self._fwd(t_starts, t_ends, densities, values, chan_set)

        def backward(t_starts, t_ends, densities, values, chan_set, grads):
            self._note(t_starts, densities, chan_set, grads)
            return self._bwd(t_starts, t_ends, densities, values, chan_set, grads)

        # the wrapped backward counts its launches on the name it is called by
        backward.launches = getattr(self._bwd, "launches", 0)
        volrend._composite_forward, volrend.composite_along_rays_bwd = forward, backward
        CallRecorder.active = True
        return self

    def __exit__(self, *exc):
        wrapped = self._mod.composite_along_rays_bwd
        if hasattr(self._bwd, "launches"):
            self._bwd.launches = wrapped.launches
        self._mod._composite_forward, self._mod.composite_along_rays_bwd = self._fwd, self._bwd
        CallRecorder.active = False
        return False


def install() -> None:
    """Wraps ``trace.profile_span`` (once, over the spans' wrapping) so that
    the span it returns holds ``k3_calls``."""
    if getattr(trace.profile_span, "k3_calls_installed", False):
        return
    spans.install()
    inner = trace.profile_span

    def profile_span(fn, device):
        if CallRecorder.active:  # wrapped twice: the outer wrapping records
            return inner(fn, device)
        with CallRecorder() as rec:
            sp = inner(fn, device)
        sp["k3_calls"] = rec.calls
        return sp

    profile_span.k3_calls_installed = True
    profile_span.spans_installed = getattr(inner, "spans_installed", False)
    profile_span.unwrapped = getattr(inner, "unwrapped", inner)
    trace.profile_span = profile_span


install()


def wide_device_seconds(intervals, calls) -> Optional[float]:
    """Device seconds of the launches of the calls past 64 channels, each
    K3 launch paired with its call by order; None where they do not pair."""
    fwd_t = [e - s for s, e, n in intervals if _FORWARD.search(n)]
    sums_t = [e - s for s, e, n in intervals if _SUMS in n]
    bwd_t = [e - s for s, e, n in intervals if _BACKWARD in n]
    fwd = [composite.is_wide(c["c"]) for c in calls if not c["backward"]]
    bwd = [composite.is_wide(c["c"]) for c in calls if c["backward"]]
    if (len(fwd_t), len(sums_t), len(bwd_t)) != (len(fwd), sum(fwd), len(bwd)):
        print(f"nerfbench: k3_wide_roofline_pct: {len(fwd_t)} forward, {len(sums_t)} sums and "
              f"{len(bwd_t)} backward K3 launches against {len(fwd)} forward calls "
              f"({sum(fwd)} wide) and {len(bwd)} backward calls: not read", file=sys.stderr)
        return None
    ns = sum(t for t, w in zip(fwd_t, fwd) if w) + sum(sums_t) \
        + sum(t for t, w in zip(bwd_t, bwd) if w)
    return ns * 1e-9


def read(tr):
    if tr is None or tr["kind"] != "train":
        return None
    sp = tr["span"]
    calls = sp.get("k3_calls") or []
    wide = [c for c in calls if composite.is_wide(c["c"])]
    if not wide or "intervals_ns" not in sp:
        return None
    device_s = wide_device_seconds(sp["intervals_ns"], calls)
    if not device_s:
        return None
    least_s = sum(composite.least_seconds(c) for c in wide)
    units = tr["units"]
    print(f"nerfbench: k3 wide route: {len(wide) / units:g} calls a unit "
          f"({sorted({(c['r'], c['s'], c['d'], c['c'], c['backward']) for c in wide})}), "
          f"least {1e3 * least_s / units:.4f} ms, device {1e3 * device_s / units:.4f} ms a unit",
          file=sys.stderr)
    return 100.0 * least_s / device_s
