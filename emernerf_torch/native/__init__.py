"""Native (C++) wire codec of the offline data path, loaded with ctypes
(port of ``emernerf_tpu/native/__init__.py``).

``wirecodec.cc`` frames TFRecords, checks their masked CRC32C and scans
protobuf fields on the host.  It is built with ``g++`` at first use into
``build/emernerf_torch/`` at the repository root (not next to the source),
through a temporary file and an atomic rename, so that concurrent
processes may build it at once.  It is an accelerator of the host codec,
never a hard dependency: with no compiler, a failed build or
``EMERNERF_NO_NATIVE`` set, ``available()`` is false and
``emernerf_torch/tools/waymo_wire.py`` runs its pure-Python codec.
``build_library`` builds and loads the package's other native source,
``zstd.cc`` (``emernerf_torch/native/zstd.py``), the same way.

Public surface (each raises ``RuntimeError`` when the library is
unavailable):

    available() -> bool
    crc32c(data: bytes) -> int
    masked_crc(data: bytes) -> int
    tfrecord_index(buf) -> (offsets, lengths) uint64 arrays
    scan_fields(buf) -> (field_num, wire_type, off, len, value) arrays
    decode_varints(buf) -> uint64 array

Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "wirecodec.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "emernerf_torch"
LIB_PATH = BUILD_DIR / "libwirecodec.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build(src: Path, out_path: str) -> bool:
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(src), "-o", out_path]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if r.returncode != 0:
        sys.stderr.write(f"emernerf_torch.native: build of {src.name} failed\n"
                         f"{r.stderr[-2000:]}\n")
        return False
    return True


def build_library(src: Path, lib_path: Path) -> Optional[ctypes.CDLL]:
    """Build ``src`` into ``lib_path`` unless the library is newer than its
    source, then load it; None with no compiler, a failed build or
    ``EMERNERF_NO_NATIVE`` set."""
    if os.environ.get("EMERNERF_NO_NATIVE"):
        return None
    if not (lib_path.exists() and lib_path.stat().st_mtime >= src.stat().st_mtime):
        # build into a temporary file beside the target, then rename it
        # into place: a process that loses the race loads the winner's
        try:
            lib_path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib_path.parent)
            os.close(fd)
        except OSError:
            return None
        try:
            if not _build(src, tmp):
                return None
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    try:
        return ctypes.CDLL(str(lib_path))
    except OSError:
        return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.en_crc32c.restype = ctypes.c_uint32
    lib.en_crc32c.argtypes = [u8p, ctypes.c_size_t]
    lib.en_masked_crc.restype = ctypes.c_uint32
    lib.en_masked_crc.argtypes = [u8p, ctypes.c_size_t]
    lib.en_tfrecord_index.restype = ctypes.c_int64
    lib.en_tfrecord_index.argtypes = [u8p, ctypes.c_uint64, u64p, u64p, ctypes.c_int64,
                                      ctypes.c_int]
    lib.en_scan_fields.restype = ctypes.c_int64
    lib.en_scan_fields.argtypes = [u8p, ctypes.c_uint64, u32p, u8p, u64p, u64p, u64p,
                                   ctypes.c_int64]
    lib.en_decode_varints.restype = ctypes.c_int64
    lib.en_decode_varints.argtypes = [u8p, ctypes.c_uint64, u64p, ctypes.c_int64]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib = build_library(SRC, LIB_PATH)
        _lib = None if lib is None else _bind(lib)
        return _lib


def available() -> bool:
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native wirecodec unavailable")
    return lib


def _as_u8(buf) -> Tuple[ctypes.POINTER(ctypes.c_uint8), int]:
    arr = np.frombuffer(buf, dtype=np.uint8)
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def crc32c(data) -> int:
    lib = _lib_or_raise()
    p, n = _as_u8(data)
    return int(lib.en_crc32c(p, n))


def masked_crc(data) -> int:
    lib = _lib_or_raise()
    p, n = _as_u8(data)
    return int(lib.en_masked_crc(p, n))


def tfrecord_index(buf, verify: int = 2):
    """Index all records of an in-memory TFRecord file image.

    Returns (offsets, lengths) uint64 arrays over ``buf``.  ``verify``:
    0 skip CRC checks, 1 check length CRCs, 2 check both (default, as the
    pure-Python reader does)."""
    lib = _lib_or_raise()
    p, n = _as_u8(buf)
    cap = max(n // 16 + 1, 1)  # a record takes at least 16 bytes
    offsets = np.empty(cap, np.uint64)
    lengths = np.empty(cap, np.uint64)
    rc = lib.en_tfrecord_index(p, n, _ptr(offsets, ctypes.c_uint64),
                               _ptr(lengths, ctypes.c_uint64), cap, verify)
    # the ctypes pointer pins a buffer export on ``buf``: drop it before
    # raising, so that a frame held by a traceback cannot block the close
    # of an mmap upstream
    del p
    if rc < 0:
        raise ValueError({-1: "truncated TFRecord", -2: "corrupt TFRecord length CRC",
                          -3: "corrupt TFRecord data CRC", -4: "index overflow"}[rc])
    return offsets[:rc], lengths[:rc]


def scan_fields(buf):
    """One-level protobuf field scan.

    Returns (field_num u32, wire_type u8, off u64, len u64, value u64)
    arrays, one entry per top-level field occurrence in ``buf``."""
    lib = _lib_or_raise()
    p, n = _as_u8(buf)
    # messages with large length-delimited payloads (camera blobs, range
    # images) have few fields: start small, grow on overflow (-4) up to
    # the n/2 bound
    cap = min(max(int(n) // 2 + 2, 4), 4096)
    while True:
        fnum = np.empty(cap, np.uint32)
        wtyp = np.empty(cap, np.uint8)
        off = np.empty(cap, np.uint64)
        ln = np.empty(cap, np.uint64)
        val = np.empty(cap, np.uint64)
        rc = lib.en_scan_fields(p, n, _ptr(fnum, ctypes.c_uint32), _ptr(wtyp, ctypes.c_uint8),
                                _ptr(off, ctypes.c_uint64), _ptr(ln, ctypes.c_uint64),
                                _ptr(val, ctypes.c_uint64), cap)
        if rc != -4:
            break
        cap = min(cap * 8, int(n) // 2 + 2)
    del p
    if rc < 0:
        raise ValueError(f"malformed protobuf message (code {rc})")
    return fnum[:rc], wtyp[:rc], off[:rc], ln[:rc], val[:rc]


def decode_varints(buf):
    """Decode a packed-varint payload to a uint64 array."""
    lib = _lib_or_raise()
    p, n = _as_u8(buf)
    cap = max(int(n), 1)
    out = np.empty(cap, np.uint64)
    rc = lib.en_decode_varints(p, n, _ptr(out, ctypes.c_uint64), cap)
    del p
    if rc < 0:
        raise ValueError(f"malformed packed varints (code {rc})")
    return out[:rc]
