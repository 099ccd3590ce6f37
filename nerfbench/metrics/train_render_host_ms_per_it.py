"""train_render_host_ms_per_it: host milliseconds per profiled iteration in the
program's ``render`` spans inside a branch of the step (``step.*``): building
each branch's forward (``render_ray_batch``: sampler, field, composite)."""

from nerfbench import spans

spans.install()


def read(tr):
    return spans.host_ms_per_unit(tr, "train", "render", under="step.")
