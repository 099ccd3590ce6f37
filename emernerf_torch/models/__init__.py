"""Fields and MLPs (mirrors ``emernerf_tpu.models``)."""
