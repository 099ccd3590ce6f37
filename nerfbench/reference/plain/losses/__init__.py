"""Training losses (mirrors ``emernerf_tpu.losses``)."""
