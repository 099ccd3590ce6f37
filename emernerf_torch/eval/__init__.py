"""Whole-image evaluation (mirrors ``emernerf_tpu.eval``)."""
