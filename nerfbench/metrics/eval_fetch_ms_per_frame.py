"""eval_fetch_ms_per_frame: milliseconds per profiled frame in the program's
``eval.fetch`` spans: every output of a chunk copied to the host
(``.cpu().numpy()``), where the host waits for the chunk's kernels."""

from nerfbench import spans

spans.install()


def read(tr):
    return spans.host_ms_per_unit(tr, "eval", "eval.fetch")
