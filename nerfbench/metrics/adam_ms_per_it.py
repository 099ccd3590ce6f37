"""adam_ms_per_it: device milliseconds of the Adam kernels (K8,
``adam_kernel``) per iteration of the profiled span."""

from nerfbench.metrics._common import device_s_per_unit


def read(tr):
    if tr is None or tr["kind"] != "train":
        return None
    t = device_s_per_unit(tr, "adam_kernel")
    return 1e3 * t if t > 0 else None
