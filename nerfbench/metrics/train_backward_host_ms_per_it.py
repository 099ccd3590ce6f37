"""train_backward_host_ms_per_it: host milliseconds per profiled iteration in
the program's ``step.backward`` spans: ``total.backward()`` of each branch,
autograd's launches and its waits."""

from nerfbench import spans

spans.install()


def read(tr):
    return spans.host_ms_per_unit(tr, "train", "step.backward")
