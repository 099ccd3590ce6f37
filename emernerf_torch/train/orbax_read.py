"""Read the orbax checkpoints the JAX package writes, without JAX.

``emernerf_tpu/train/checkpoints.py`` saves a ``TrainState`` with orbax's
``StandardCheckpointer``: a directory holding ``_METADATA`` (the tree, as
JSON) and an OCDBT database (``manifest.ocdbt``, ``d/*`` and the per-process
``ocdbt.process_<i>/``) whose keys are zarr v2 arrays, one per leaf
(``<leaf>/.zarray`` and its chunks ``<leaf>/0.0``...).  This module reads
that layout with numpy and the port's own native code:

- **OCDBT.**  Every manifest and B-tree node is one envelope: a 4-byte
  big-endian magic, the file's length as a little-endian u64, a version
  and a compression varint (1 = zstd), the body, and a little-endian
  CRC32C of every byte before it (checked with the wire codec's
  ``crc32c``).  The manifest holds the config and the newest versions
  inline; each version names its root node by (data file, offset,
  length).  A node holds its height, a table of the data files it
  references (prefix-compressed relative paths under a base path, so the
  top-level database reaches into ``ocdbt.process_0/``), and column-wise
  entries: prefix-compressed keys, then for a leaf node each value inline
  or as a (file, offset, length) reference, for an interior node each
  child's reference and the key prefix its subtree shares.
- **zarr v2.**  ``.zarray`` gives shape, chunks, dtype (``<f4``, ``<i4``,
  ``<u4`` or ``bfloat16``), order C and the zstd compressor; the chunks
  are decoded by ``emernerf_torch/native/zstd.cc`` straight into the
  array where a chunk is a contiguous part of it, and assembled in C
  order otherwise.  A missing chunk raises unless ``fill_value`` is set.
- **The tree.**  ``_METADATA``'s ``tree_metadata`` maps each leaf's key
  path (dict keys and sequence indices) to its value type; the leaves come
  back as CPU torch tensors (a ``bfloat16`` leaf as uint16 viewed as
  ``torch.bfloat16``), ``None`` where orbax saved an empty state.

Every structural check raises ``OrbaxFormatError`` naming the file.  The
zstd decoder has no fallback: without the native library reading raises.

    is_orbax_checkpoint(path) -> bool
    read_tree(path) -> nested dicts / lists of tensors
    read_jax_train_state(path) -> dict(step, params, prop_params, adam, prop_adam)
    OcdbtReader(root).items() / .value(v)
"""

from __future__ import annotations

import ast
import json
import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
ENVELOPE_MIN = 4 + 8 + 1 + 1 + 4

# zarr v2 dtype strings -> (numpy dtype of the bytes, torch dtype it is viewed as)
# (the dtypes a TrainState's leaves take; another raises)
_DTYPES = {
    "<f4": (np.float32, torch.float32), "bfloat16": (np.uint16, torch.bfloat16),
    "<i4": (np.int32, torch.int32), "<u4": (np.uint32, torch.uint32),
}

# what the last read_tree took: arrays, bytes on disk, bytes decoded, seconds
last_read: Dict[str, float] = {}


class OrbaxFormatError(ValueError):
    pass


def is_orbax_checkpoint(path: str) -> bool:
    """A directory the JAX package's orbax checkpointer wrote."""
    return (os.path.isdir(path) and os.path.isfile(os.path.join(path, "_METADATA"))
            and os.path.isfile(os.path.join(path, "manifest.ocdbt")))


def _zstd():
    from emernerf_torch.native import zstd

    if not zstd.available():
        raise RuntimeError(
            "reading an orbax checkpoint needs the native zstd decoder "
            f"({zstd.SRC}), which could not be built or loaded (g++ missing, or "
            "EMERNERF_NO_NATIVE set)")
    return zstd


def _crc32c(data) -> int:
    from emernerf_torch import native

    return native.crc32c(data)


class _Bytes:
    """A cursor over a decoded body; every fault names the file."""

    def __init__(self, data: bytes, path: str):
        self.data, self.pos, self.path = data, 0, path

    def fail(self, what: str):
        raise OrbaxFormatError(f"{self.path}: {what} (at byte {self.pos})")

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            self.fail(f"truncated: {n} bytes wanted")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            if shift > 63:
                self.fail("varint longer than 64 bits")
            b = self.byte()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _envelope(data: bytes, path: str, magic: int) -> bytes:
    """The body of one OCDBT file (or node), its framing checked."""
    if len(data) < ENVELOPE_MIN:
        raise OrbaxFormatError(f"{path}: {len(data)} bytes, shorter than an OCDBT envelope")
    got = int.from_bytes(data[:4], "big")
    if got != magic:
        raise OrbaxFormatError(f"{path}: magic {got:#010x}, expected {magic:#010x}")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise OrbaxFormatError(f"{path}: length field {length}, {len(data)} bytes read")
    want = int.from_bytes(data[-4:], "little")
    if _crc32c(data[:-4]) != want:
        raise OrbaxFormatError(f"{path}: CRC32C mismatch")
    c = _Bytes(data[:-4], path)
    c.pos = 12
    version = c.varint()
    if version != 0:
        c.fail(f"OCDBT format version {version}")
    compression = c.varint()
    body = data[c.pos:-4]
    if compression == 0:
        return body
    if compression != 1:
        c.fail(f"compression {compression}")
    try:
        return _zstd().decompress(body)
    except ValueError as e:
        raise OrbaxFormatError(f"{path}: {e}") from e


def _data_files(c: _Bytes) -> List[str]:
    """A data file table: each file's path under the database root."""
    n = c.varint()
    prefix = c.varints(n - 1) if n else []
    suffix = c.varints(n)
    base = c.varints(n)
    paths, prev = [], b""
    for i in range(n):
        keep = prefix[i - 1] if i else 0
        if keep > len(prev):
            c.fail("data file path prefix longer than the previous path")
        full = prev[:keep] + c.take(suffix[i])
        if base[i] > len(full):
            c.fail("data file base path longer than its path")
        prev = full
        rel = full.decode()
        if rel.startswith("/") or ".." in rel.split("/"):
            c.fail(f"data file path {rel!r} leaves the database")
        paths.append(rel)
    return paths


def _refs(c: _Bytes, n: int, files: List[str]) -> List[Tuple[str, int, int]]:
    """n (data file, offset, length) references and their statistics."""
    ids = c.varints(n)
    offsets = c.varints(n)
    lengths = c.varints(n)
    c.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
    for i in ids:
        if i >= len(files):
            c.fail(f"data file id {i} of {len(files)}")
    return [(files[i], o, ln) for i, o, ln in zip(ids, offsets, lengths)]


def _keys(c: _Bytes, n: int) -> Tuple[List[int], List[int]]:
    prefix = c.varints(n - 1) if n else []
    suffix = c.varints(n)
    return [0] + prefix, suffix


def _key_bytes(c: _Bytes, prefix: List[int], suffix: List[int]) -> List[bytes]:
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            c.fail("key prefix longer than the previous key")
        prev = prev[:p] + c.take(s)
        keys.append(prev)
    return keys


class OcdbtReader:
    """The newest version of the OCDBT database rooted at ``root``."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.read_bytes = 0
        self._lock = threading.Lock()  # values are read on a pool of threads
        path = os.path.join(self.root, "manifest.ocdbt")
        c = _Bytes(_envelope(self._file(path), path, MANIFEST_MAGIC), path)
        self.uuid = c.take(16)
        kind = c.varint()
        if kind != 0:
            c.fail(f"manifest kind {kind} (only a single-file manifest is read)")
        self.max_inline_value_bytes = c.varint()
        self.max_decoded_node_bytes = c.varint()
        self.version_tree_arity_log2 = c.byte()
        compression = c.varint()
        if compression == 1:
            c.take(4)  # zstd level
        elif compression != 0:
            c.fail(f"compression method {compression}")
        files = _data_files(c)
        n = c.varint()
        if n == 0:
            c.fail("no inline version (an empty database)")
        generations = c.varints(n)
        heights = [c.byte() for _ in range(n)]
        refs = _refs(c, n, files)
        newest = max(range(n), key=generations.__getitem__)
        self.generation = generations[newest]
        self._root_ref, self._root_height = refs[newest], heights[newest]
        # the commit times and the version tree nodes (older versions) follow

    def _file(self, path: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read() if length is None else f.read(length)
        except OSError as e:
            raise OrbaxFormatError(f"{path}: {e}") from e
        if length is not None and len(data) != length:
            raise OrbaxFormatError(f"{path}: {len(data)} bytes at {offset}, {length} referenced")
        with self._lock:
            self.read_bytes += len(data)
        return data

    def _node(self, ref: Tuple[str, int, int], height: int, prefix: bytes):
        rel, offset, length = ref
        path = os.path.join(self.root, rel)
        where = f"{path}@{offset}"
        c = _Bytes(_envelope(self._file(path, offset, length), where, NODE_MAGIC), where)
        got = c.byte()
        if got != height:
            c.fail(f"node height {got}, its parent says {height}")
        files = _data_files(c)
        n = c.varint()
        if n == 0:
            c.fail("empty node")
        kp, ks = _keys(c, n)
        if height == 0:
            keys = _key_bytes(c, kp, ks)
            lengths = c.varints(n)
            kinds = [c.byte() for _ in range(n)]
            if any(k > 1 for k in kinds):
                c.fail(f"value kind {max(kinds)}")
            m = sum(kinds)
            ids, offsets = c.varints(m), c.varints(m)
            if any(i >= len(files) for i in ids):
                c.fail("value data file id out of range")
            out, j = [], 0
            for key, kind, ln in zip(keys, kinds, lengths):
                if kind == 0:
                    out.append((prefix + key, c.take(ln)))
                else:
                    out.append((prefix + key, (files[ids[j]], offsets[j], ln)))
                    j += 1
            if c.pos != len(c.data):
                c.fail(f"{len(c.data) - c.pos} bytes after the last value")
            return out, []
        shared = c.varints(n)
        keys = _key_bytes(c, kp, ks)
        refs = _refs(c, n, files)
        if c.pos != len(c.data):
            c.fail(f"{len(c.data) - c.pos} bytes after the last child")
        children = []
        for key, k, ref in zip(keys, shared, refs):
            if k > len(key):
                c.fail("subtree prefix longer than its key")
            children.append((ref, prefix + key[:k]))
        return [], children

    def items(self) -> Iterator[Tuple[bytes, object]]:
        """Every (key, value) in key order: a value is its bytes when held
        inline, else a (data file, offset, length) reference."""
        stack = [(self._root_ref, self._root_height, b"")]
        while stack:
            ref, height, prefix = stack.pop()
            leaves, children = self._node(ref, height, prefix)
            yield from leaves
            stack.extend((r, height - 1, p) for r, p in reversed(children))

    def value(self, v) -> bytes:
        if isinstance(v, (bytes, bytearray)):
            return bytes(v)
        rel, offset, length = v
        return self._file(os.path.join(self.root, rel), offset, length)


# ---------------------------------------------------------------- zarr v2
def _zarray(meta_bytes: bytes, where: str) -> dict:
    try:
        meta = json.loads(meta_bytes)
    except ValueError as e:
        raise OrbaxFormatError(f"{where}: .zarray is not JSON ({e})") from e
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{where}: zarr_format {meta.get('zarr_format')}, 2 expected")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{where}: order {meta['order']} (only C is read)")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{where}: filters {meta['filters']}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{where}: compressor {comp}")
    if meta.get("dtype") not in _DTYPES:
        raise OrbaxFormatError(f"{where}: dtype {meta.get('dtype')!r}")
    if len(meta["shape"]) != len(meta["chunks"]):
        raise OrbaxFormatError(f"{where}: shape {meta['shape']}, chunks {meta['chunks']}")
    return meta


def _chunk_keys(shape, chunks, sep) -> Iterator[Tuple[Tuple[int, ...], str]]:
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    if not shape:
        yield (), "0"
        return
    for idx in np.ndindex(*grid):
        yield idx, sep.join(str(i) for i in idx)


class _Stats:
    def __init__(self):
        self.lock = threading.Lock()
        self.disk = self.decoded = 0

    def add(self, disk: int, decoded: int):
        with self.lock:
            self.disk += disk
            self.decoded += decoded


def _read_chunk(db: OcdbtReader, value, meta, np_dtype, out: np.ndarray, idx, where: str,
                stats: _Stats):
    shape, chunks = meta["shape"], meta["chunks"]
    data = db.value(value)
    nbytes = int(np.prod(chunks, dtype=np.int64)) * np.dtype(np_dtype).itemsize
    region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
    view = out[region] if region else out  # out[()] of a 0-d array is a copy
    edge = any(sl.stop - sl.start != c for sl, c in zip(region, chunks))
    direct = (not edge) and view.flags.c_contiguous
    dst = view if direct else np.empty(chunks, np_dtype)
    if meta.get("compressor") is None:
        if len(data) != nbytes:
            raise OrbaxFormatError(f"{where}: raw chunk of {len(data)} bytes, {nbytes} expected")
        dst.reshape(-1).view(np.uint8)[:] = np.frombuffer(data, np.uint8)
    else:
        try:
            got = _zstd().decompress_into(data, dst.reshape(-1).view(np.uint8))
        except ValueError as e:
            raise OrbaxFormatError(f"{where}: {e}") from e
        if got != nbytes:
            raise OrbaxFormatError(f"{where}: chunk decoded to {got} bytes, {nbytes} expected")
    if not direct:
        view[...] = dst[tuple(slice(0, sl.stop - sl.start) for sl in region)]
    stats.add(len(data), nbytes)


def _fill(meta, np_dtype, out: np.ndarray, region, where: str):
    fill = meta.get("fill_value")
    if fill is None:
        raise OrbaxFormatError(f"{where}: chunk missing and no fill_value")
    if meta["dtype"] == "bfloat16":
        fill = int(torch.tensor(float(fill), dtype=torch.bfloat16).view(torch.uint16))
    out[region] = np.asarray(fill).astype(np_dtype)


def read_arrays(db: OcdbtReader, names, workers: Optional[int] = None,
                stats: Optional[_Stats] = None) -> Dict[str, torch.Tensor]:
    """The zarr arrays ``names`` of ``db`` as CPU tensors; chunks decoded on
    a pool of threads (the decoder releases the GIL)."""
    stats = stats or _Stats()
    index = dict(db.items())
    arrays, jobs = {}, []
    for name in names:
        where = f"{db.root}:{name}"
        meta_value = index.get(f"{name}/.zarray".encode())
        if meta_value is None:
            raise OrbaxFormatError(f"{where}: no .zarray in the database")
        meta = _zarray(db.value(meta_value), where)
        np_dtype, torch_dtype = _DTYPES[meta["dtype"]]
        out = np.empty(meta["shape"], np_dtype)
        sep = meta.get("dimension_separator", ".")
        for idx, key in _chunk_keys(meta["shape"], meta["chunks"], sep):
            value = index.get(f"{name}/{key}".encode())
            if value is None:
                region = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, meta["chunks"]))
                _fill(meta, np_dtype, out, region, f"{where}/{key}")
            else:
                jobs.append((value, meta, np_dtype, out, idx, f"{where}/{key}"))
        t = torch.from_numpy(out)
        arrays[name] = t.view(torch_dtype) if torch_dtype == torch.bfloat16 else t
    workers = workers or min(8, os.cpu_count() or 1)
    if workers <= 1 or len(jobs) <= 1:
        for job in jobs:
            _read_chunk(db, *job[:5], job[5], stats)
    else:
        with ThreadPoolExecutor(workers) as pool:
            # larger chunks first, so that the longest decode starts at once
            jobs.sort(key=lambda j: -(j[0][2] if isinstance(j[0], tuple) else len(j[0])))
            for f in [pool.submit(_read_chunk, db, *job[:5], job[5], stats) for job in jobs]:
                f.result()
    return arrays


# ---------------------------------------------------------------- the tree
def _metadata(path: str) -> dict:
    meta_path = os.path.join(path, "_METADATA")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise OrbaxFormatError(f"{meta_path}: {e}") from e
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise OrbaxFormatError(f"{meta_path}: use_ocdbt={meta.get('use_ocdbt')} "
                               f"use_zarr3={meta.get('use_zarr3')} (OCDBT with zarr v2 is read)")
    if "tree_metadata" not in meta:
        raise OrbaxFormatError(f"{meta_path}: no tree_metadata")
    return meta


def _leaves(meta: dict, meta_path: str):
    """(key path as [(key, is_sequence)], array name or None) of every leaf."""
    for k, entry in meta["tree_metadata"].items():
        try:
            names = ast.literal_eval(k)
            keys = [(m["key"], m["key_type"]) for m in entry["key_metadata"]]
            value = entry["value_metadata"]
        except (ValueError, SyntaxError, KeyError, TypeError) as e:
            raise OrbaxFormatError(f"{meta_path}: tree entry {k!r}: {e}") from e
        if [str(x) for x in names] != [str(key) for key, _ in keys]:
            raise OrbaxFormatError(f"{meta_path}: tree entry {k!r} and its key_metadata differ")
        if any(t not in (1, 2) for _, t in keys):
            raise OrbaxFormatError(f"{meta_path}: tree entry {k!r}: key types "
                                   f"{[t for _, t in keys]}")
        empty = value.get("value_type") == "None" or value.get("skip_deserialize", False)
        yield [(key, t == 1) for key, t in keys], None if empty else ".".join(
            str(key) for key, _ in keys)


def _nest(entries, meta_path: str):
    """Nested dicts and lists from (key path, leaf) pairs; a sequence's
    indices must run from 0 without a gap."""
    root: dict = {}
    kinds: Dict[int, bool] = {}

    def container(node, is_seq, where):
        if id(node) in kinds and kinds[id(node)] != is_seq:
            raise OrbaxFormatError(f"{meta_path}: {where} is both a sequence and a dict")
        kinds[id(node)] = is_seq

    for path, leaf in entries:
        node = root
        for depth, (key, is_seq) in enumerate(path):
            container(node, is_seq, path[:depth])
            k = int(key) if is_seq else key
            if depth == len(path) - 1:
                if k in node:
                    raise OrbaxFormatError(f"{meta_path}: leaf {path} twice")
                node[k] = leaf
            else:
                node = node.setdefault(k, {})

    def build(node):
        if not isinstance(node, dict):
            return node
        if kinds.get(id(node), False):
            if sorted(node) != list(range(len(node))):
                raise OrbaxFormatError(f"{meta_path}: sequence indices {sorted(node)}")
            return [build(node[i]) for i in range(len(node))]
        return {k: build(v) for k, v in node.items()}

    return build(root)


def read_tree(path: str, workers: Optional[int] = None):
    """The tree an orbax ``StandardCheckpointer`` saved at ``path``: nested
    dicts and lists of CPU tensors (None for saved empty states)."""
    t0 = time.perf_counter()
    path = os.path.abspath(path)
    meta = _metadata(path)
    entries = list(_leaves(meta, os.path.join(path, "_METADATA")))
    db = OcdbtReader(path)
    stats = _Stats()
    arrays = read_arrays(db, [n for _, n in entries if n is not None], workers, stats)
    tree = _nest([(p, None if n is None else arrays[n]) for p, n in entries],
                 os.path.join(path, "_METADATA"))
    last_read.clear()
    last_read.update(arrays=len(arrays), disk_bytes=db.read_bytes, chunk_bytes=stats.disk,
                     decoded_bytes=stats.decoded, seconds=time.perf_counter() - t0)
    return tree


def _adam(opt_state, where: str) -> dict:
    """The optax ``ScaleByAdamState`` (count, mu, nu) of an optimizer state
    (a chain's tuple of states, the empty ones None)."""
    found = [s for s in (opt_state if isinstance(opt_state, list) else [opt_state])
             if isinstance(s, dict) and {"count", "mu", "nu"} <= set(s)]
    if len(found) != 1:
        raise OrbaxFormatError(f"{where}: {len(found)} Adam states (count, mu, nu) found")
    return found[0]


def read_jax_train_state(path: str, workers: Optional[int] = None) -> dict:
    """A JAX ``TrainState`` checkpoint: ``step`` (int), ``params``,
    ``prop_params`` (a list, one tree per proposal net), and ``adam`` and
    ``prop_adam``, each a dict of ``count``, ``mu`` and ``nu``, the
    leaves CPU tensors in their stored dtypes, as
    ``emernerf_torch.convert.load_jax_train_state`` takes them."""
    tree = read_tree(path, workers)
    missing = {"step", "params", "prop_params", "opt_state", "prop_opt_state"} - set(tree)
    if missing:
        raise OrbaxFormatError(f"{path}: not a TrainState (no {sorted(missing)})")
    return {"step": int(tree["step"]), "params": tree["params"],
            "prop_params": tree["prop_params"], "adam": _adam(tree["opt_state"], path),
            "prop_adam": _adam(tree["prop_opt_state"], path)}
