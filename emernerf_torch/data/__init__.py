"""Scene datasets (mirrors ``emernerf_tpu.data``)."""
