"""eval_metrics_host_ms_per_frame: host milliseconds per profiled frame in the
program's ``eval.metrics`` spans: PSNR, SSIM and the masked metrics on the
host (``ImageRenderer.render_split``)."""

from nerfbench import spans

spans.install()


def read(tr):
    return spans.host_ms_per_unit(tr, "eval", "eval.metrics")
