"""eval_rays_host_ms_per_frame: host milliseconds per profiled frame in the
program's ``eval.rays`` spans: the frame's rays built on the host
(``dataset.get_image_rays``), padded to whole chunks and wrapped as tensors."""

from nerfbench import spans

spans.install()


def read(tr):
    return spans.host_ms_per_unit(tr, "eval", "eval.rays")
