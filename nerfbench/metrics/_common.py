"""What the per-layer readers share: device time per unit (iteration or
frame) of the profiled span, by kernel name."""

from nerfbench import trace


def device_s_per_unit(tr, *needles) -> float:
    return trace.kernel_seconds(tr["span"], *needles) / tr["units"]


def busy_s_per_unit(tr) -> float:
    return tr["span"]["busy_s"] / tr["units"]


def least_grid_s_per_unit(tr, brick: bool, backward: bool) -> float:
    key = "backward_s" if backward else "forward_s"
    return sum(c[key] for c in tr["grid_calls"] if c["brick"] == brick) / tr["units"]


def roofline_pct(tr, brick: bool, backward: bool, *needles):
    """The grid calls' least time over their kernels' device time, in %;
    None where the span ran no such kernel or made no such call."""
    t = device_s_per_unit(tr, *needles)
    least = least_grid_s_per_unit(tr, brick, backward)
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least / t
