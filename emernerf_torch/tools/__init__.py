"""Offline tools of the data path (mirrors ``emernerf_tpu.tools``): the
Waymo TFRecord preprocessor, its wire codec, the scene-list readers and
the DINO feature extractor."""
