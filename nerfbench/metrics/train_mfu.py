"""train_mfu: the least time the iteration's model FLOPs need at the
published peaks (``counts/flops.py``) over the unprofiled seconds per
iteration, in %."""


def read(tr):
    if tr is None or tr["kind"] != "train":
        return None
    return 100.0 * tr["flops"]["least_s"] / tr["unprofiled_s_per_unit"]
