"""Pure-Python Waymo Open Dataset Frame codec and TFRecord IO (port of
``emernerf_tpu/tools/waymo_wire.py``; its schema tables are held to the
original's by ``tests/test_torch_native.py``).

The reference parses scene TFRecords with ``tensorflow`` +
``waymo_open_dataset`` (datasets/waymo_preprocess.py:21-23); neither is on
the card's machine, so the port's preprocessor reads through this
dependency-free codec of exactly the slice of the format it consumes:

* a protobuf **wire-format** decoder/encoder for the Frame message tree,
  schema-driven, so that the encoder (which builds fixtures and
  ``chip_smoke.py``'s raw scene) and the decoder share one field-number
  table;
* ``parse_range_image_and_camera_projection``, the counterpart of
  ``waymo_open_dataset.utils.frame_utils``'s (zlib MatrixFloat decoding,
  first/second return, the top lidar's per-pixel pose);
* TFRecord reading and writing with masked-CRC32C framing, byte-compatible
  with ``tf.io.TFRecordWriter`` / ``tf.data.TFRecordDataset``.  Records are
  framed and CRC-checked by the native codec (``emernerf_torch.native``)
  where it builds, else in Python; ``read_tfrecords.records`` counts the
  records each framed.

Field numbers follow the public waymo-open-dataset ``dataset.proto`` /
``label.proto``.  Only fields the preprocessor reads are modelled; unknown
fields are skipped on decode.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib
from types import SimpleNamespace
from typing import Any, Dict, Iterable, Iterator, List

import numpy as np

from emernerf_torch import native as _native

# --------------------------------------------------------------------- #
# Schema: message name -> {field_number: (attr_name, kind, label)}
# kind: double | float | int32 | int64 | uint32 | enum | bytes | string
#       | msg:<MessageName>
# label: one | rep
# --------------------------------------------------------------------- #
SCHEMA: Dict[str, Dict[int, tuple]] = {
    # dataset.proto
    "MatrixShape": {1: ("dims", "int32", "rep")},
    "MatrixFloat": {1: ("data", "float", "rep"), 2: ("shape", "msg:MatrixShape", "one")},
    "Transform": {1: ("transform", "double", "rep")},
    "CameraCalibration": {
        1: ("name", "enum", "one"),
        2: ("intrinsic", "double", "rep"),
        3: ("extrinsic", "msg:Transform", "one"),
        4: ("width", "int32", "one"),
        5: ("height", "int32", "one"),
        6: ("rolling_shutter_direction", "enum", "one"),
    },
    "LaserCalibration": {
        1: ("name", "enum", "one"),
        2: ("beam_inclinations", "double", "rep"),
        3: ("beam_inclination_min", "double", "one"),
        4: ("beam_inclination_max", "double", "one"),
        5: ("extrinsic", "msg:Transform", "one"),
    },
    "Context": {
        1: ("name", "string", "one"),
        2: ("camera_calibrations", "msg:CameraCalibration", "rep"),
        3: ("laser_calibrations", "msg:LaserCalibration", "rep"),
    },
    # Public dataset.proto numbering: field 1 is the DEPRECATED
    # uncompressed `MatrixFloat range_image` (absent in modern segments);
    # the zlib-compressed fields occupy 2..5.
    "RangeImage": {
        1: ("range_image", "msg:MatrixFloat", "one"),  # deprecated
        2: ("range_image_compressed", "bytes", "one"),
        3: ("camera_projection_compressed", "bytes", "one"),
        4: ("range_image_pose_compressed", "bytes", "one"),
        5: ("range_image_flow_compressed", "bytes", "one"),
    },
    "CameraImage": {
        1: ("name", "enum", "one"),
        2: ("image", "bytes", "one"),
        3: ("pose", "msg:Transform", "one"),
        5: ("pose_timestamp", "double", "one"),
        6: ("shutter", "double", "one"),
        7: ("camera_trigger_time", "double", "one"),
        8: ("camera_readout_done_time", "double", "one"),
    },
    "Laser": {
        1: ("name", "enum", "one"),
        2: ("ri_return1", "msg:RangeImage", "one"),
        3: ("ri_return2", "msg:RangeImage", "one"),
    },
    # label.proto
    # Public label.proto Label.Box numbering is NON-SEQUENTIAL: the file
    # declares, under the comment "length: dim x. width: dim y.",
    #     optional double length = 5;
    #     optional double width = 4;
    # i.e. field 4 = width (dim y), field 5 = length (dim x); the
    # sequential-looking {4: length, 5: width} would rotate every box
    # footprint by 90 degrees in the dynamic-mask projection.
    "LabelBox": {
        1: ("center_x", "double", "one"),
        2: ("center_y", "double", "one"),
        3: ("center_z", "double", "one"),
        4: ("width", "double", "one"),
        5: ("length", "double", "one"),
        6: ("height", "double", "one"),
        7: ("heading", "double", "one"),
    },
    "LabelMetadata": {
        1: ("speed_x", "double", "one"),
        2: ("speed_y", "double", "one"),
        3: ("accel_x", "double", "one"),
        4: ("accel_y", "double", "one"),
    },
    "Label": {
        1: ("box", "msg:LabelBox", "one"),
        2: ("metadata", "msg:LabelMetadata", "one"),
        3: ("type", "enum", "one"),
        4: ("id", "string", "one"),
        # occlusion-filter fields (public waymo label.proto numbering)
        7: ("num_lidar_points_in_box", "int32", "one"),
        13: ("num_top_lidar_points_in_box", "int32", "one"),
    },
    "Frame": {
        1: ("context", "msg:Context", "one"),
        2: ("timestamp_micros", "int64", "one"),
        3: ("pose", "msg:Transform", "one"),
        4: ("images", "msg:CameraImage", "rep"),
        5: ("lasers", "msg:Laser", "rep"),
        6: ("laser_labels", "msg:Label", "rep"),
    },
}

_SCALAR_DEFAULTS = {
    "double": 0.0, "float": 0.0, "int32": 0, "int64": 0, "uint32": 0,
    "enum": 0, "bytes": b"", "string": "",
}
_VARINT_KINDS = {"int32", "int64", "uint32", "enum"}
_FIXED = {"double": ("<d", 8, 1), "float": ("<f", 4, 5)}


# --------------------------------------------------------------------- #
# wire primitives
# --------------------------------------------------------------------- #
def _read_varint(buf: bytes, i: int):
    result, shift = 0, 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _write_varint(v: int) -> bytes:
    if v < 0:  # proto int32/int64 negatives use 10-byte two's complement
        v += 1 << 64
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _default_message(name: str) -> SimpleNamespace:
    out = SimpleNamespace()
    for attr, kind, label in SCHEMA[name].values():
        if label == "rep":
            setattr(out, attr, [])
        elif kind.startswith("msg:"):
            setattr(out, attr, _default_message(kind[4:]))
        else:
            setattr(out, attr, _SCALAR_DEFAULTS[kind])
    return out


def decode(buf, msg_name: str) -> SimpleNamespace:
    """Wire bytes -> attribute namespace with schema defaults filled in.

    Repeated scalar fields decode to numpy arrays (f8/f4 for double/float,
    i8 for varints); every consumer goes through ``np.asarray`` anyway.

    The Python tag walk with numpy packed-array decode, as in the
    original: on field-dense label messages the native field-scanner walk
    (`_decode_native`) pays a ctypes and numpy call per submessage, and
    large payloads are copies either way.  The native codec's work is the
    TFRecord framing and CRC check (``read_tfrecords``)."""
    return _decode_py(bytes(buf), msg_name)


_REP_DTYPE = {"double": np.float64, "float": np.float32,
              "int32": np.int64, "int64": np.int64, "uint32": np.int64,
              "enum": np.int64}


def _finalize_rep(out: SimpleNamespace, msg_name: str) -> SimpleNamespace:
    """Repeated-scalar staging lists -> one numpy array per field."""
    for attr, kind, label in SCHEMA[msg_name].values():
        if label != "rep" or kind.startswith("msg:") or kind in (
            "bytes", "string"
        ):
            continue
        parts = getattr(out, attr)
        dt = _REP_DTYPE[kind]
        if not parts:
            setattr(out, attr, np.empty(0, dt))
        else:
            setattr(
                out, attr,
                np.concatenate([np.asarray(p, dt).reshape(-1) for p in parts])
            )
    return out


def _decode_native(mv, msg_name: str) -> SimpleNamespace:
    """Schema walk over the native one-level field scan (zero-copy spans).

    Not the default path (see ``decode``); held to `_decode_py` by
    tests/test_torch_native.py and ``chip_smoke.py`` phase 16b, it is the
    consumer of ``native.scan_fields``."""
    fields = SCHEMA[msg_name]
    out = _default_message(msg_name)
    fnum, wtyp, off, ln, vals = _native.scan_fields(mv)
    for k in range(fnum.shape[0]):
        spec = fields.get(int(fnum[k]))
        if spec is None:
            continue
        attr, kind, label = spec
        wire = int(wtyp[k])
        o, l = int(off[k]), int(ln[k])
        if kind.startswith("msg:"):
            sub = _decode_native(mv[o:o + l], kind[4:])
            if label == "rep":
                getattr(out, attr).append(sub)
            else:
                setattr(out, attr, sub)
        elif kind == "bytes":
            setattr(out, attr, bytes(mv[o:o + l])) if label == "one" \
                else getattr(out, attr).append(bytes(mv[o:o + l]))
        elif kind == "string":
            s = bytes(mv[o:o + l]).decode()
            setattr(out, attr, s) if label == "one" \
                else getattr(out, attr).append(s)
        elif kind in _FIXED:
            fmt, size, _ = _FIXED[kind]
            arr = np.frombuffer(mv[o:o + l],
                                dtype="<f8" if kind == "double" else "<f4")
            if label == "rep":
                getattr(out, attr).append(arr)
            else:
                setattr(out, attr, float(arr[0]))
        elif kind in _VARINT_KINDS:
            if wire == 2:  # packed
                raw = _native.decode_varints(mv[o:o + l])
                v = raw.view(np.int64) if kind in ("int32", "int64") else raw
                getattr(out, attr).append(v)
            else:
                v = _signed(int(vals[k]), kind)
                if label == "rep":
                    getattr(out, attr).append(v)
                else:
                    setattr(out, attr, v)
        else:
            raise ValueError(f"unknown kind {kind}")
    return _finalize_rep(out, msg_name)


def _decode_py(buf: bytes, msg_name: str) -> SimpleNamespace:
    fields = SCHEMA[msg_name]
    out = _default_message(msg_name)
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        spec = fields.get(field)
        if spec is None:  # unknown field: skip by wire type
            if wire == 0:
                _, i = _read_varint(buf, i)
            elif wire == 1:
                i += 8
            elif wire == 2:
                ln, i = _read_varint(buf, i)
                i += ln
            elif wire == 5:
                i += 4
            else:
                raise ValueError(f"unsupported wire type {wire} in {msg_name}")
            continue
        attr, kind, label = spec
        if kind.startswith("msg:"):
            ln, i = _read_varint(buf, i)
            sub = _decode_py(buf[i : i + ln], kind[4:])
            i += ln
            if label == "rep":
                getattr(out, attr).append(sub)
            else:
                setattr(out, attr, sub)
        elif kind in ("bytes", "string"):
            ln, i = _read_varint(buf, i)
            raw = buf[i : i + ln]
            i += ln
            val = raw.decode() if kind == "string" else raw
            if label == "rep":
                getattr(out, attr).append(val)
            else:
                setattr(out, attr, val)
        elif kind in _FIXED:
            fmt, size, wt = _FIXED[kind]
            if wire == 2:  # packed
                ln, i = _read_varint(buf, i)
                arr = np.frombuffer(
                    buf, dtype="<f8" if kind == "double" else "<f4",
                    count=ln // size, offset=i,
                )
                i += ln
                getattr(out, attr).append(arr)
            else:
                (v,) = struct.unpack_from(fmt, buf, i)
                i += size
                if label == "rep":
                    getattr(out, attr).append(v)
                else:
                    setattr(out, attr, v)
        elif kind in _VARINT_KINDS:
            if wire == 2:  # packed
                ln, i = _read_varint(buf, i)
                end = i + ln
                while i < end:
                    v, i = _read_varint(buf, i)
                    getattr(out, attr).append(_signed(v, kind))
            else:
                v, i = _read_varint(buf, i)
                if label == "rep":
                    getattr(out, attr).append(_signed(v, kind))
                else:
                    setattr(out, attr, _signed(v, kind))
        else:
            raise ValueError(f"unknown kind {kind}")
    return _finalize_rep(out, msg_name)


def _signed(v: int, kind: str) -> int:
    if kind == "int32" and v >= 1 << 31:
        return v - (1 << 64) if v >= 1 << 63 else v - (1 << 32)
    if kind == "int64" and v >= 1 << 63:
        return v - (1 << 64)
    return v


def _pack_fixed(values, kind: str) -> bytes:
    """A packed run of doubles or floats: the bytes of ``struct.pack`` per
    value (round to nearest, OverflowError past the float range), made by
    numpy in one pass."""
    wide = np.asarray(values, np.float64).reshape(-1)
    if kind == "double":
        return wide.astype("<f8").tobytes()
    with np.errstate(over="ignore"):
        narrow = wide.astype("<f4")
    if np.any(np.isinf(narrow) & ~np.isinf(wide)):
        raise OverflowError("float too large to pack with f format")
    return narrow.tobytes()


def encode(msg_name: str, values: Dict[str, Any]) -> bytes:
    """Dict tree -> wire bytes (fixtures and raw records; repeated scalars packed)."""
    fields = SCHEMA[msg_name]
    by_attr = {spec[0]: (num, spec[1], spec[2]) for num, spec in fields.items()}
    out = b""
    for attr, val in values.items():
        num, kind, label = by_attr[attr]
        if kind.startswith("msg:"):
            sub_name = kind[4:]
            items = val if label == "rep" else [val]
            for item in items:
                payload = encode(sub_name, item)
                out += _write_varint(num << 3 | 2) + _write_varint(len(payload)) + payload
        elif kind in ("bytes", "string"):
            items = val if label == "rep" else [val]
            for item in items:
                raw = item.encode() if kind == "string" else bytes(item)
                out += _write_varint(num << 3 | 2) + _write_varint(len(raw)) + raw
        elif kind in _FIXED:
            fmt, size, wt = _FIXED[kind]
            if label == "rep":
                payload = _pack_fixed(val, kind)
                out += _write_varint(num << 3 | 2) + _write_varint(len(payload)) + payload
            else:
                out += _write_varint(num << 3 | wt) + struct.pack(fmt, float(val))
        elif kind in _VARINT_KINDS:
            if label == "rep":
                payload = b"".join(_write_varint(int(v)) for v in val)
                out += _write_varint(num << 3 | 2) + _write_varint(len(payload)) + payload
            else:
                out += _write_varint(num << 3 | 0) + _write_varint(int(val))
        else:
            raise ValueError(f"unknown kind {kind}")
    return out


def parse_frame(buf: bytes) -> SimpleNamespace:
    return decode(buf, "Frame")


def encode_frame(values: Dict[str, Any]) -> bytes:
    return encode("Frame", values)


def encode_matrix_float(data: np.ndarray) -> bytes:
    """numpy array -> serialized MatrixFloat (used to build range images)."""
    return encode(
        "MatrixFloat",
        {
            "data": np.asarray(data, np.float32).reshape(-1),
            "shape": {"dims": list(data.shape)},
        },
    )


# --------------------------------------------------------------------- #
# frame_utils equivalent
# --------------------------------------------------------------------- #
def _decode_mf(compressed: bytes):
    ns = decode(zlib.decompress(compressed), "MatrixFloat")
    ns.data = np.asarray(ns.data, np.float32)
    return ns


def parse_range_image_and_camera_projection(frame):
    """Drop-in for waymo_open_dataset.utils.frame_utils.<same name>.

    Returns (range_images, camera_projections, seg_labels, top_pose) where
    ``range_images[laser_name]`` is a list of MatrixFloat-like objects
    (``.data`` flat float32 array, ``.shape.dims``) per return, and
    ``top_pose`` is the TOP lidar's per-pixel pose MatrixFloat (or None).
    Camera projections / segmentation labels are not decoded (the
    preprocessor does not consume them)."""
    range_images: Dict[int, List] = {}
    top_pose = None
    for laser in frame.lasers:
        returns = []
        for ret in (laser.ri_return1, laser.ri_return2):
            if ret is None or len(ret.range_image_compressed) == 0:
                continue
            returns.append(_decode_mf(ret.range_image_compressed))
        if returns:
            range_images[laser.name] = returns
        if (
            laser.name == 1  # TOP
            and laser.ri_return1 is not None
            and len(laser.ri_return1.range_image_pose_compressed) > 0
        ):
            top_pose = _decode_mf(laser.ri_return1.range_image_pose_compressed)
    return range_images, {}, None, top_pose


# --------------------------------------------------------------------- #
# TFRecord framing (masked CRC32C, byte-compatible with TensorFlow)
# --------------------------------------------------------------------- #
_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc_py(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    if _native.available():
        return _native.masked_crc(data)
    return _masked_crc_py(data)


def write_tfrecords(path: str, records: Iterable[bytes]) -> None:
    with open(path, "wb") as f:
        for rec in records:
            length = struct.pack("<Q", len(rec))
            f.write(length)
            f.write(struct.pack("<I", _masked_crc(length)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))


def read_tfrecords(path: str) -> Iterator[bytes]:
    """The records of a TFRecord file, each CRC-checked: framed by the
    native codec where it is available, else in Python."""
    if _native.available():
        yield from _read_native(path)
    else:
        yield from _read_py(path)


# records framed by each codec since the caller last set them to 0
read_tfrecords.records = {"native": 0, "python": 0}


def _read_native(path: str) -> Iterator[bytes]:
    """mmap the file, index and CRC-check every record in one C++ pass,
    then yield each record's bytes."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            return
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            try:
                offsets, lengths = _native.tfrecord_index(mm, verify=2)
            except ValueError as e:
                raise ValueError(f"{e} in {path}") from None
            for o, ln in zip(offsets.tolist(), lengths.tolist()):
                read_tfrecords.records["native"] += 1
                yield mm[o:o + ln]


def _read_py(path: str) -> Iterator[bytes]:
    """The pure-Python reader: the CRCs in Python too."""
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                return
            (length,) = struct.unpack("<Q", head)
            (len_crc,) = struct.unpack("<I", f.read(4))
            if len_crc != _masked_crc_py(head):
                raise ValueError(f"corrupt TFRecord length CRC in {path}")
            rec = f.read(length)
            (rec_crc,) = struct.unpack("<I", f.read(4))
            if rec_crc != _masked_crc_py(rec):
                raise ValueError(f"corrupt TFRecord data CRC in {path}")
            read_tfrecords.records["python"] += 1
            yield rec
