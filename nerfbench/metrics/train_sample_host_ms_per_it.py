"""train_sample_host_ms_per_it: host milliseconds per profiled iteration in the
program's ``trainer.sample`` spans: the proposal schedule, the pixel and lidar
draws and batches, the render draws (``Trainer.train_iteration``)."""

from nerfbench import spans

spans.install()


def read(tr):
    return spans.host_ms_per_unit(tr, "train", "trainer.sample")
