"""Optimizer, train state, train step and trainer (mirrors ``emernerf_tpu.train``)."""
