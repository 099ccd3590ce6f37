"""The least work of one compositing call (K3), forward or backward, from
its shape alone: R rays of S samples, D density sets, C value channels, all
float32.

Bytes: each input read once and each output written once.

- Forward: in ``t_starts``, ``t_ends`` (R, S), the densities (R, S, D) and
  the values (R, S, C); out the weights and the transmittance (R, S, D),
  the opacity and the depth (R, D), the median depth (R, 1) and the sums
  (R, C).
- Backward: in ``t_starts``, ``t_ends``, the densities, the values and the
  cotangents the call is given (of the weights and the transmittance
  (R, S, D), the opacity and the depth (R, D), the sums (R, C)); out the
  densities' gradient (R, S, D) and the values' (R, S, C).

Operations: per (ray, sample, set) the forward's six (the step's optical
depth, its running sum, two exponentials, one minus, the weight) and the
backward's twelve (those six again and the six of the suffix sum's terms);
per (ray, sample, channel) the forward's multiply-add and the backward's
three (the value's gradient, the weight's multiply-add).  They take under
a fortieth of the bytes' time at the wide route's shapes; the bytes set
the bound.
"""

from __future__ import annotations

from typing import Dict, Sequence

from nerfbench.counts import peaks

F32 = 4
# above this many value channels K3 takes its wide route
# (render/volrend.py:_STAGED_CHANNELS)
WIDE_CHANNELS = 64
# the cotangents of the backward, in the order composite_along_rays_bwd takes them
COTANGENTS = ("weights", "trans", "opacity", "depth", "sums")


def is_wide(c: int) -> bool:
    return c > WIDE_CHANNELS


def ops(r: int, s: int, d: int, c: int, backward: bool) -> float:
    per_set, per_chan = (12, 3) if backward else (6, 2)
    return float(r) * s * (per_set * d + per_chan * c)


def bytes_moved(r: int, s: int, d: int, c: int, backward: bool,
                cotangents: Sequence[str] = ()) -> float:
    """Each input read once, each output written once (module docstring);
    ``cotangents``: the names (``COTANGENTS``) the backward is given."""
    inputs = 2 * r * s + r * s * d + r * s * c
    if backward:
        size = {"weights": r * s * d, "trans": r * s * d, "opacity": r * d, "depth": r * d,
                "sums": r * c}
        elems = inputs + sum(size[g] for g in cotangents) + r * s * d + r * s * c
    else:
        elems = inputs + 2 * r * s * d + 2 * r * d + r + r * c
    return float(F32 * elems)


def least_seconds(call: Dict) -> float:
    """The larger of the operations over the fp32 rate and the bytes over
    the HBM rate, of one recorded call: ``r``, ``s``, ``d``, ``c``,
    ``backward`` and, backward, ``cotangents``."""
    args = (call["r"], call["s"], call["d"], call["c"], call["backward"])
    return max(ops(*args) / peaks.FP32_FLOPS,
               bytes_moved(*args, call.get("cotangents", ())) / peaks.HBM_BYTES_PER_S)
