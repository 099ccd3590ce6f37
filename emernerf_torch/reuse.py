"""Framework-free modules of the JAX package, imported without JAX.

``emernerf_tpu/data/synthetic.py`` and ``emernerf_tpu/eval/metrics.py``
import only numpy, but their packages' ``__init__`` files import the JAX
renderer and scene tensors.  They are loaded here straight from their files,
so the port reuses them without copying and without pulling in ``jax``.
``emernerf_tpu.config`` needs no such care: its package ``__init__`` is
empty.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_TPU_PKG = Path(__file__).resolve().parents[1] / "emernerf_tpu"


def _load(relpath: str):
    name = "emernerf_torch._reused_" + relpath.replace("/", "_")[:-3]
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, _TPU_PKG / relpath)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


synthetic = _load("data/synthetic.py")
metrics = _load("eval/metrics.py")
