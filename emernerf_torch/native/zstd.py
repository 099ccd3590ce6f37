"""The native zstd decoder (``zstd.cc``), loaded with ctypes.

Built with ``g++`` at first use into ``build/emernerf_torch/libemzstd.so``
as the wire codec is (``emernerf_torch.native.build_library``).  Unlike
the wire codec it has no fallback: ``decompress_into`` raises
``RuntimeError`` when the library cannot be built or ``EMERNERF_NO_NATIVE``
is set, so a checkpoint is never read through the pure-Python decoder
(``zstd_plain.py``, the tests' plain version).

    available() -> bool
    decompress_into(src, dst) -> int   decode into a preallocated array
    decompress(src) -> bytes
    content_size(src) -> int           -1 when the header has none

``frames`` and ``bytes_out`` count the calls that decoded and the bytes
they wrote, so a caller can show that this decoder ran.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from emernerf_torch.native import BUILD_DIR, build_library
from emernerf_torch.native.zstd_plain import ZstdError

SRC = Path(__file__).resolve().parent / "zstd.cc"
LIB_PATH = BUILD_DIR / "libemzstd.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
frames = 0
bytes_out = 0

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib = build_library(SRC, LIB_PATH)
        if lib is not None:
            lib.emz_decompress.restype = ctypes.c_int64
            lib.emz_decompress.argtypes = [_u8p, ctypes.c_uint64, _u8p, ctypes.c_uint64]
            lib.emz_content_size.restype = ctypes.c_int64
            lib.emz_content_size.argtypes = [_u8p, ctypes.c_uint64]
            lib.emz_error.restype = ctypes.c_char_p
            lib.emz_error.argtypes = [ctypes.c_int64]
            lib.emz_xxh64.restype = ctypes.c_uint64
            lib.emz_xxh64.argtypes = [_u8p, ctypes.c_uint64, ctypes.c_uint64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native zstd decoder ({SRC.name}) could not be built or "
                           "loaded (g++ missing, or EMERNERF_NO_NATIVE set)")
    return lib


def _src(src) -> np.ndarray:
    return np.frombuffer(src, dtype=np.uint8)


def _check(lib, rc: int) -> int:
    if rc < 0:
        raise ZstdError(lib.emz_error(rc).decode())
    return rc


def decompress_into(src, dst: np.ndarray) -> int:
    """Decode every frame of ``src`` into ``dst`` (a writable C-contiguous
    array of any dtype, filled from its first byte); returns the bytes
    written.  Raises ``ZstdError`` on a malformed input or one that does not
    fit."""
    global frames, bytes_out
    lib = _lib_or_raise()
    if not (dst.flags.c_contiguous and dst.flags.writeable):
        raise ValueError("decompress_into needs a writable C-contiguous destination")
    s = _src(src)
    rc = _check(lib, lib.emz_decompress(s.ctypes.data_as(_u8p), s.size,
                                        ctypes.cast(dst.ctypes.data, _u8p), dst.nbytes))
    with _lock:  # callers decode on threads
        frames += 1
        bytes_out += rc
    return rc


def content_size(src) -> int:
    lib = _lib_or_raise()
    s = _src(src)
    rc = lib.emz_content_size(s.ctypes.data_as(_u8p), s.size)
    return -1 if rc == -1 else _check(lib, rc)


def decompress(src) -> bytes:
    """Every frame of ``src``: sized by the first frame's header, or grown
    until it fits when the header gives no size."""
    n = content_size(src)
    cap = n if n >= 0 else max(4 * len(src), 1 << 16)
    while True:
        out = np.empty(cap, np.uint8)
        try:
            k = decompress_into(src, out)
            return out[:k].tobytes()
        except ZstdError as e:
            if "larger than the destination" not in str(e) or cap > (1 << 34):
                raise
            cap *= 4


def xxh64(data, seed: int = 0) -> int:
    lib = _lib_or_raise()
    s = _src(data)
    return int(lib.emz_xxh64(s.ctypes.data_as(_u8p), s.size, seed))
