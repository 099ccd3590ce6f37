"""The port's native wire codec (``emernerf_torch/native``) and its copy of
the Frame codec (``emernerf_torch/tools/waymo_wire.py``) against the JAX
package's and against the port's own pure-Python codec, bit for bit:
CRC32C known answers and every length, TFRecord framing (with corruption
and a length near 2^64), the field scan (with malformed input), and the
decode of random frames.  Also: the library is built under
``build/emernerf_torch/``, the C++ source and the schema tables are the
originals'."""

import os
import struct

import numpy as np
import pytest

from emernerf_tpu import native as jax_native
from emernerf_tpu.tools import waymo_wire as jax_ww
from emernerf_torch import native
from emernerf_torch.tools import waymo_wire as ww

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.available() or not jax_native.available():
        pytest.skip("native wirecodec unavailable (no g++?)")


def _tree_equal(a, b, path="root"):
    """Structural equality of decoded SimpleNamespace trees, arrays bit for
    bit (NaN payloads included) and of the same dtype."""
    if type(a).__name__ == "SimpleNamespace":
        assert type(b).__name__ == "SimpleNamespace", path
        assert vars(a).keys() == vars(b).keys(), path
        for k in vars(a):
            _tree_equal(getattr(a, k), getattr(b, k), f"{path}.{k}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b) and a == b, f"{path}: {a!r} != {b!r}"


def _random_frame_values(rng):
    """tests/test_native.py's random frame, with a laser carrying every
    compressed range-image field."""
    return {
        "context": {
            "name": "segment-" + str(int(rng.integers(1e9))),
            "camera_calibrations": [
                {"name": int(c), "intrinsic": rng.normal(size=9).tolist(),
                 "extrinsic": {"transform": rng.normal(size=16).tolist()},
                 "width": 1920, "height": 1280, "rolling_shutter_direction": 1}
                for c in range(1, 4)],
            "laser_calibrations": [
                {"name": 1, "beam_inclinations": rng.normal(size=64).tolist(),
                 "extrinsic": {"transform": rng.normal(size=16).tolist()}}],
        },
        "timestamp_micros": int(rng.integers(1 << 40)),
        "pose": {"transform": rng.normal(size=16).tolist()},
        "images": [{"name": 1, "image": rng.integers(0, 256, 1000, dtype=np.uint8).tobytes(),
                    "pose_timestamp": float(rng.normal())}],
        "lasers": [{"name": 1, "ri_return1": {
            "range_image_compressed": rng.integers(0, 256, 300, dtype=np.uint8).tobytes(),
            "range_image_pose_compressed": b"pose",
            "range_image_flow_compressed": b"flow"}}],
        "laser_labels": [
            {"box": {"center_x": float(rng.normal()), "center_y": float(rng.normal()),
                     "heading": float(rng.normal())},
             "metadata": {"speed_x": float(rng.normal())}, "type": 1, "id": "label-x",
             "num_lidar_points_in_box": int(rng.integers(100)),
             "num_top_lidar_points_in_box": int(rng.integers(100))}],
    }


def test_library_is_built_under_build_not_in_the_package():
    assert native.LIB_PATH.parent == native.BUILD_DIR
    assert native.BUILD_DIR == native.SRC.parents[2] / "build" / "emernerf_torch"
    assert native.LIB_PATH.is_file()
    assert not [f for f in os.listdir(native.SRC.parent) if f.endswith(".so")]


def test_wirecodec_source_is_the_originals():
    """The code below the includes is the JAX package's, line for line
    (the header comment names the port's modules)."""
    def code(path):
        text = open(path).read()
        return text[text.index("#include <cstdint>"):]

    assert code(native.SRC) == code(os.path.join(REPO, "emernerf_tpu/native/wirecodec.cc"))


def test_schema_tables_are_the_originals():
    assert ww.SCHEMA == jax_ww.SCHEMA
    assert ww._SCALAR_DEFAULTS == jax_ww._SCALAR_DEFAULTS
    assert ww._VARINT_KINDS == jax_ww._VARINT_KINDS and ww._FIXED == jax_ww._FIXED
    assert ww._REP_DTYPE == jax_ww._REP_DTYPE


@pytest.mark.parametrize("data,crc", [(b"", 0), (b"123456789", 0xE3069283),
                                      (bytes(32), 0x8A9136AA), (bytes([0xFF] * 32), 0x62A8AB43)])
def test_crc32c_known_answers(data, crc):
    """RFC 3720 (iSCSI) test vectors, through both packages' libraries and
    the port's Python CRC."""
    assert native.crc32c(data) == jax_native.crc32c(data) == ww._crc32c(data) == crc


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 63, 64, 65, 1000, 4097])
def test_crc32c_and_masked_crc_match_at_every_length(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert (native.crc32c(data) == jax_native.crc32c(data) == ww._crc32c(data)
            == jax_ww._crc32c(data))
    assert (native.masked_crc(data) == jax_native.masked_crc(data) == ww._masked_crc_py(data)
            == ww._masked_crc(data))


def _write(tmp_path, recs, name="t.tfrecord"):
    p = str(tmp_path / name)
    ww.write_tfrecords(p, recs)
    return p


RECORDS = [b"a", b"", b"x" * 1000, bytes(range(256))]


def test_tfrecord_files_are_byte_identical_and_index_alike(tmp_path):
    p = _write(tmp_path, RECORDS)
    q = str(tmp_path / "jax.tfrecord")
    jax_ww.write_tfrecords(q, RECORDS)
    raw = open(p, "rb").read()
    assert raw == open(q, "rb").read()
    for verify in (0, 1, 2):
        offsets, lengths = native.tfrecord_index(raw, verify=verify)
        ref = jax_native.tfrecord_index(raw, verify=verify)
        np.testing.assert_array_equal(offsets, ref[0])
        np.testing.assert_array_equal(lengths, ref[1])
        assert [raw[o:o + n] for o, n in zip(offsets.tolist(), lengths.tolist())] == RECORDS


def test_readers_agree_and_count_their_records(tmp_path):
    p = _write(tmp_path, RECORDS)
    counts = ww.read_tfrecords.records
    before = dict(counts)
    assert list(ww._read_native(p)) == list(ww._read_py(p)) == list(jax_ww.read_tfrecords(p))
    assert list(ww.read_tfrecords(p)) == RECORDS
    assert counts["native"] - before["native"] == 2 * len(RECORDS)
    assert counts["python"] - before["python"] == len(RECORDS)


@pytest.mark.parametrize("reader", ["native", "python"])
def test_corrupt_records_raise(tmp_path, reader):
    read = {"native": ww._read_native, "python": ww._read_py}[reader]
    p = _write(tmp_path, [b"hello world"])
    raw = bytearray(open(p, "rb").read())
    raw[13] ^= 1  # a payload byte
    open(p, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="data CRC"):
        list(read(p))
    with pytest.raises(ValueError, match="data CRC"):
        native.tfrecord_index(bytes(raw), verify=2)
    # verify=0 trusts the CRCs and still frames
    assert native.tfrecord_index(bytes(raw), verify=0)[1].tolist() == [11]
    with pytest.raises(ValueError, match="truncated"):
        native.tfrecord_index(bytes(raw[:-2]), verify=0)
    raw[0] ^= 1  # the length
    open(p, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="length CRC"):
        list(read(p))


@pytest.mark.parametrize("verify", [0, 1, 2])
def test_tfrecord_index_huge_length_fails_cleanly(verify):
    """A record length near 2^64 must not wrap the bounds check."""
    hdr = struct.pack("<Q", (1 << 64) - 8)
    rec = hdr + struct.pack("<I", ww._masked_crc(hdr)) + b"payload!" + bytes(4)
    for lib in (native, jax_native):
        with pytest.raises(ValueError, match="truncated"):
            lib.tfrecord_index(rec, verify=verify)


@pytest.mark.parametrize("buf", [b"\x0a\xff", b"\x80", b"\x0b", b"\x0a" + b"\xff" * 9 + b"\x01x"],
                         ids=["truncated_payload", "truncated_tag", "group", "huge_length"])
def test_scan_fields_rejects_malformed(buf):
    for lib in (native, jax_native):
        with pytest.raises(ValueError):
            lib.scan_fields(buf)


def test_scan_fields_and_varints_match_the_original():
    buf = ww.encode_frame(_random_frame_values(np.random.default_rng(4)))
    for a, b in zip(native.scan_fields(buf), jax_native.scan_fields(buf)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    shape = ww.encode("MatrixShape", {"dims": [2, 3, 4, 1 << 40]})
    fnum, wtyp, off, ln, _ = native.scan_fields(shape)
    assert fnum.tolist() == [1] and wtyp.tolist() == [2]  # packed
    payload = shape[int(off[0]):int(off[0]) + int(ln[0])]
    assert native.decode_varints(payload).tolist() == [2, 3, 4, 1 << 40]
    with pytest.raises(ValueError):
        native.decode_varints(b"\x80")


@pytest.mark.parametrize("seed", range(4))
def test_frames_encode_and_decode_bit_for_bit(seed):
    """Random frames encode to the JAX encoder's bytes, and the port's
    native and Python walks decode them to the JAX walks' trees."""
    values = _random_frame_values(np.random.default_rng(seed))
    buf = ww.encode_frame(values)
    assert buf == jax_ww.encode_frame(values)
    ref = jax_ww._decode_py(buf, "Frame")
    _tree_equal(ww._decode_py(buf, "Frame"), ref)
    _tree_equal(ww._decode_native(memoryview(buf), "Frame"), ref)
    _tree_equal(ww._decode_native(memoryview(buf), "Frame"),
                jax_ww._decode_native(memoryview(buf), "Frame"))
    _tree_equal(ww.parse_frame(buf), jax_ww.parse_frame(buf))


def test_negative_varints_and_matrix_floats():
    buf = ww.encode("Label", {"num_lidar_points_in_box": -5, "num_top_lidar_points_in_box": -1})
    assert buf == jax_ww.encode("Label", {"num_lidar_points_in_box": -5,
                                          "num_top_lidar_points_in_box": -1})
    a = ww._decode_native(memoryview(buf), "Label")
    assert a.num_lidar_points_in_box == -5 and a.num_top_lidar_points_in_box == -1
    _tree_equal(a, ww._decode_py(buf, "Label"))
    arr = np.random.default_rng(5).normal(size=(3, 5, 4)).astype(np.float32)
    arr[0, 0, 0] = np.nan
    mf = ww.encode_matrix_float(arr)
    assert mf == jax_ww.encode_matrix_float(arr)
    dec = ww.decode(mf, "MatrixFloat")
    assert dec.shape.dims.tolist() == [3, 5, 4]
    assert dec.data.tobytes() == arr.tobytes()
    with pytest.raises(OverflowError):
        ww.encode("MatrixFloat", {"data": [1e39]})


def test_range_images_parse_as_the_original():
    rng = np.random.default_rng(6)
    ri, pose = rng.normal(size=(4, 6, 4)).astype(np.float32), rng.normal(size=(4, 6, 6))
    import zlib

    frame = ww.encode_frame({"lasers": [
        {"name": 1, "ri_return1": {
            "range_image_compressed": zlib.compress(ww.encode_matrix_float(ri)),
            "range_image_pose_compressed": zlib.compress(ww.encode_matrix_float(pose))},
         "ri_return2": {"range_image_compressed": zlib.compress(ww.encode_matrix_float(ri[::-1]))}},
        {"name": 2, "ri_return1": {"range_image_compressed":
                                   zlib.compress(ww.encode_matrix_float(ri[:2]))}}]})
    ours = ww.parse_range_image_and_camera_projection(ww.parse_frame(frame))
    ref = jax_ww.parse_range_image_and_camera_projection(jax_ww.parse_frame(frame))
    _tree_equal(ours[0], ref[0])
    _tree_equal(ours[3], ref[3])
    assert ours[1] == ref[1] == {} and ours[2] is ref[2] is None
    np.testing.assert_array_equal(ours[0][1][1].data.reshape(4, 6, 4), ri[::-1])
