"""eval_idle_pct: 1 - the device's busy seconds per frame of the profiled
frame over the same run's unprofiled seconds per frame, in %."""

from nerfbench.metrics._common import busy_s_per_unit


def read(tr):
    if tr is None or tr["kind"] != "eval":
        return None
    return 100.0 * (1.0 - busy_s_per_unit(tr) / tr["unprofiled_s_per_unit"])
