"""eval_mfu: the least time the frame's model FLOPs need at the published
peaks (``counts/flops.py``) over the unprofiled seconds per frame, in %."""


def read(tr):
    if tr is None or tr["kind"] != "eval":
        return None
    return 100.0 * tr["flops"]["least_s"] / tr["unprofiled_s_per_unit"]
