"""Build, bind and count the port's hand-written Hopper kernels.

All kernels live in ``csrc/*.cu`` with a plain C interface.  On first use
``load()`` compiles them with ``nvcc`` (one process per source, all started
together), links ONE shared library under ``build/emernerf_torch/`` at the
repository root and binds it with ``ctypes``.  Every pointer and the stream
go over as ``c_void_p``; every C entry returns ``cudaGetLastError()`` and
:func:`check` raises on a non-zero code.  There is no fallback: a CUDA tensor that reaches a wrapper
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the entry points (all return cudaError_t as int)
_SIGNATURES = {
    # table, table_is_bf16, compute_is_bf16, positions, out, n_points,
    # params (host struct), stream
    "emt_brickgrid_encode": (_P, _I, _I, _P, _P, _L, _P, _P),
    # s_vals, cdfs, u_base, jitter|NULL, out, n_rays, n_in_edges, n_out_edges, stream
    "emt_importance_sampling": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # t_starts, t_ends, dens (R,S,D), vals (R,S,C)|NULL, packed channel
    # sets (host array of 8 uint64), n_rays, S, D, C, out (weights, trans,
    # opacity, depth, median, sums one after the other), stream
    "emt_composite": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    # t_starts, t_ends, dens, vals|NULL, packed channel sets (as
    # emt_composite), n_rays, S, D, C, g_weights, g_trans, g_opacity,
    # g_depth, g_sums (each |NULL), d_dens, d_vals|NULL, stream
    "emt_composite_backward": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _P, _P, _P, _P, _P, _P, _P, _P),
    # table, table_is_bf16, compute_is_bf16, positions, grad_out, d_table
    # (fp32), d_pos|NULL, n_points, params (host struct), stream
    "emt_brickgrid_backward": (_P, _I, _I, _P, _P, _P, _P, _L, _P, _P),
    # s_final (R,K+1), trans_final (R,K), levels (host array of
    # ops/stepfuns.py:_Level: cache_s (R,M+1), cache_cdfs (R,M+1), w_s out
    # (R,M), half-width r, M+1), n_levels, loss out (L,R), n_rays, K+1, stream
    "emt_interlevel_forward": (_P, _P, _P, _I, _P, _I, _I, _P),
    # levels (w_s (R,M), cache_cdfs (R,M+1), d_cdfs out (R,M+1), -, M+1),
    # n_levels, g_loss (L,R), its two strides, n_rays, stream
    "emt_interlevel_backward": (_P, _I, _P, _L, _L, _I, _P),
    # param, grad|NULL, mu, nu, moments_bf16, n, hyper (host struct), stream
    "emt_adam": (_P, _P, _P, _P, _I, _L, _P, _P),
    # K11: leaves (host array of train/optim.py:SpmdLeaf), n_leaves (<= 64),
    # hyper (host struct), stream
    "emt_spmd_adam_multi": (_P, _I, _P, _P),
    # slab (wire dtype), wire_bf16, p_local (fp32), mu, nu, moments_bf16,
    # dir_out, dir_bf16, n, n_ranks, hyper (host struct), vec (8 or 1), stream
    "emt_zero_slab": (_P, _I, _P, _P, _P, _I, _P, _I, _L, _F, _P, _I, _P),
    # param, dir, dir_bf16, n, neg_lr, vec (8 or 1), stream
    "emt_apply_direction": (_P, _P, _I, _L, _F, _I, _P),
    # K12: lines, lines_is_bf16, compute_is_bf16, positions, out (fp32),
    # n_points, params (host struct), stream
    "emt_mxgrid_encode": (_P, _I, _I, _P, _P, _L, _P, _P),
    # lines, lines_is_bf16, compute_is_bf16, positions, grad_out (fp32),
    # d_lines (zeroed fp32), d_pos|NULL, its scratch (S * slots, n, D) fp32
    # |NULL, n_points, params (host struct), stream
    "emt_mxgrid_backward": (_P, _I, _I, _P, _P, _P, _P, _P, _L, _P, _P),
    # table (F, rows), elem_bytes (2 or 4), out (rows, F), rows, F, stream
    "emt_hashgrid_features_minor": (_P, _I, _P, _L, _I, _P),
    # table (L*T, F) features-minor, table_is_bf16, positions, out, n_points,
    # params (host struct), stream
    "emt_hashgrid_encode": (_P, _I, _P, _P, _L, _P, _P),
    # table (L*T, F) features-minor, table_is_bf16, positions, grad_out,
    # scratch (zeroed fp32 (L*T, F)), d_table ((F, L*T) in the table's
    # dtype), d_pos|NULL, n_points, params (host struct), stream
    "emt_hashgrid_backward": (_P, _I, _P, _P, _P, _P, _P, _L, _P, _P),
    # table, idx (int32), out, n, row_bytes, vec_bytes, stream
    "emt_gather_loop": (_P, _P, _P, _L, _I, _I, _P),
    # table, idx (int32), out, n, row_bytes, stream
    "emt_gather_take": (_P, _P, _P, _L, _I, _P),
    # idx (int32), upd (fp32), out (zeroed fp32), n, w, vec_bytes, stream
    "emt_scatter_rmw": (_P, _P, _P, _L, _I, _I, _P),
    # rows (int32), upd (fp32), out (zeroed fp32), n, t, w, tile_n,
    # shared_table, stream
    "emt_scatter_onehot": (_P, _P, _P, _L, _I, _I, _I, _I, _P),
    # pred, gt (h, w, c) fp32, mask (h, w) bytes|NULL, h, w, c, win, ssim,
    # partials (float64 scratch), out (6 float64), stream
    "emt_image_metrics": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
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


def _stale(lib: Path) -> bool:
    """Whether a source or header is newer than the library: a library built
    before a source changed (or was added) lacks its entry points or runs
    old code."""
    built = lib.stat().st_mtime
    return any(src.stat().st_mtime > built
               for src in (*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")))


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the shared library, unless one newer than
    every source exists; returns its path."""
    out = BUILD_DIR / LIB_NAME
    if out.exists() and not force and not _stale(out):
        return out
    nvcc = nvcc_path()
    if not (os.path.isfile(nvcc) and os.access(nvcc, os.X_OK)):
        raise KernelBuildError(f"nvcc not found (looked for {nvcc!r}); "
                               "the CUDA kernels cannot be built")
    sources = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objects = [BUILD_DIR / (src.stem + ".o") for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objects)]
    logs = [p.communicate()[0] for p in procs]
    _State.build_log = "".join(logs)
    failed = [src.name for src, p in zip(sources, procs) if p.returncode != 0]
    tmp = BUILD_DIR / (LIB_NAME + ".tmp")
    if not failed:
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objects)], capture_output=True, text=True)
        _State.build_log += link.stdout + link.stderr
        failed = ["link"] if link.returncode != 0 else []
    if failed:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on {failed}:\n{_State.build_log[-4000:]}")
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
    """Common wrapper checks for the kernel path: one CUDA device and
    contiguous inputs.  Gradients are the autograd.Functions' business."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def dispatch_device(name: str, t: torch.Tensor) -> str:
    """'cpu' -> the plain version, 'cuda' -> the kernel, anything else raises."""
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return kind
