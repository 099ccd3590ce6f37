"""Leaf math and encoders (mirrors ``emernerf_tpu.ops``)."""
