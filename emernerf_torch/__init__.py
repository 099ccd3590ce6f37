"""EmerNeRF in PyTorch with hand-written CUDA kernels for Hopper.

The JAX package ``emernerf_tpu`` is the reference; module paths and names
here mirror it.  This package never imports ``jax``.
"""
