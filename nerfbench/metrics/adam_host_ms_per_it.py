"""adam_host_ms_per_it: host milliseconds per profiled iteration in the
program's ``optim.update`` spans: each branch's Adam update, a launch a
tensor (``train/optim.py:apply_update``); ``adam_ms_per_it`` is its device time."""

from nerfbench import spans

spans.install()


def read(tr):
    return spans.host_ms_per_unit(tr, "train", "optim.update")
