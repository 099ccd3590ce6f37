"""nerfbench: the benchmark of emernerf_torch on the H100 (see README.md)."""
