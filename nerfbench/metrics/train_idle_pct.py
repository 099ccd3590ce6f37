"""train_idle_pct: 1 - the device's busy seconds per iteration of the
profiled span over the same run's unprofiled seconds per iteration, in %."""

from nerfbench.metrics._common import busy_s_per_unit


def read(tr):
    if tr is None or tr["kind"] != "train":
        return None
    return 100.0 * (1.0 - busy_s_per_unit(tr) / tr["unprofiled_s_per_unit"])
