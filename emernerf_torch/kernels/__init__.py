"""Build, bind and count the port's hand-written Hopper kernels.

All kernels live in ``csrc/*.cu`` with a plain C interface.  On first use
``load()`` compiles them with ``nvcc`` into ONE shared library under
``build/emernerf_torch/`` at the repository root and binds it with
``ctypes``.  Every pointer and the stream go over as ``c_void_p``; every C
entry returns ``cudaGetLastError()`` and :func:`check` raises on a
non-zero code.  There is no fallback: a CUDA tensor that reaches a wrapper
whose kernel does not build or launch raises.

Nothing here runs at import time, so the CPU tests can import every module.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "emernerf_torch"
LIB_NAME = "libemernerf_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures of the entry points (all return cudaError_t as int)
_SIGNATURES = {
    # table, table_is_bf16, positions, out, n_points, params (host struct), stream
    "emt_brickgrid_encode": (_P, _I, _P, _P, _L, _P, _P),
    # s_vals, cdfs, u_base, jitter|NULL, out, n_rays, n_in_edges, n_out_edges, stream
    "emt_importance_sampling": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # t_starts, t_ends, dens (R,S,D), vals (R,S,C)|NULL, chan_set (C) host,
    # n_rays, S, D, C, weights, trans, opacity, depth, median, sums, stream
    "emt_composite": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _P, _P, _P, _P, _P, _P, _P),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


class _State:
    lib = None
    build_log = ""


def nvcc_path() -> str:
    """The nvcc on ``PATH``, else the CUDA toolkit's default location."""
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the shared library; returns its path."""
    out = BUILD_DIR / LIB_NAME
    if out.exists() and not force:
        return out
    nvcc = nvcc_path()
    if not (os.path.isfile(nvcc) and os.access(nvcc, os.X_OK)):
        raise KernelBuildError(f"nvcc not found (looked for {nvcc!r}); "
                               "the CUDA kernels cannot be built")
    sources = sorted(str(p) for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / (LIB_NAME + ".tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _State.build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{_State.build_log[-4000:]}")
    tmp.replace(out)
    return out


def load():
    """The bound library, building it on first use."""
    if _State.lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _State.lib = lib
    return _State.lib


def build_log() -> str:
    """nvcc's output of the last build (``-Xptxas -v`` register counts)."""
    return _State.build_log


def check(err: int, name: str) -> None:
    if err != 0:
        raise KernelLaunchError(f"{name}: CUDA error {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda_inputs(name: str, *tensors: torch.Tensor) -> None:
    """Common wrapper checks for the kernel path: one CUDA device, contiguous
    inputs, and no autograd graph (the backward kernels come with training)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError(
                f"{name}: the CUDA kernel is forward-only; run it under "
                "torch.no_grad() (its backward is ported with training)")


def dispatch_device(name: str, t: torch.Tensor) -> str:
    """'cpu' -> the plain version, 'cuda' -> the kernel, anything else raises."""
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return kind
