"""Proposal sampling, compositing and ray-batch rendering (mirrors ``emernerf_tpu.render``)."""
