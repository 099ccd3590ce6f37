"""The port's zstd decoders on the CPU: the native one
(``emernerf_torch/native/zstd.cc``) and its plain version
(``emernerf_torch/native/zstd_plain.py``), each held to the ``zstandard``
library (installed here; the tests' reference only) bit for bit:
- hypothesis payloads (random, skewed-text, repeated and zero runs) at
  levels -5, 1, 3 and 19, with and without a checksum and a content size;
- fixed payloads that reach every part of the format, counted by the plain
  decoder's ``seen``: frames of several blocks (> 128 KiB), RLE and raw
  blocks, raw, RLE, 1- and 4-stream Huffman and treeless literals, the
  predefined, RLE, compressed and repeat sequence tables, repeat offsets,
  streamed frames without a content size, concatenated and skippable frames;
- every zstd frame of a real orbax directory (the OCDBT nodes' bodies and
  the zarr chunks).
A flipped byte raises wherever ``zstandard`` raises, and where it does not
the output is the original's; a checksum flip and a frame that names a
dictionary raise in both decoders.
"""

import io
import os

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from emernerf_torch.native import zstd as native
from emernerf_torch.native import zstd_plain as plain
from emernerf_torch.native.zstd_plain import ZstdError

LEVELS = (-5, 1, 3, 19)

pytestmark = pytest.mark.skipif(not native.available(), reason="no g++ to build zstd.cc")


def _compress(data, level=3, checksum=False, content_size=True):
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size).compress(data)


def _both(frame):
    """Both decoders' output; they must agree."""
    a, b = native.decompress(frame), plain.decompress(frame)
    assert a == b
    return a


def _skewed(rng, n, k=26, a=1.3):
    p = 1 / np.arange(1, k + 1) ** a
    return (rng.choice(k, n, p=p / p.sum()) + 97).astype(np.uint8).tobytes()


@st.composite
def payloads(draw):
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    kind = draw(st.sampled_from(["random", "skewed", "repeats", "zeros", "mixed"]))
    n = draw(st.sampled_from([0, 1, 17, 1000, 40_000, 140_000]))
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "skewed":
        return _skewed(rng, n)
    if kind == "repeats":
        unit = rng.integers(0, 256, draw(st.integers(1, 300)), dtype=np.uint8).tobytes()
        return (unit * (n // len(unit) + 1))[:n]
    if kind == "zeros":
        return bytes(n)
    parts = [rng.integers(0, 256, 300, dtype=np.uint8).tobytes(), _skewed(rng, 500), bytes(200)]
    return b"".join(parts[i] for i in rng.integers(0, 3, max(n // 300, 1)))[:n]


@settings(max_examples=40, deadline=None, derandomize=True)
@given(data=payloads(), level=st.sampled_from(LEVELS), checksum=st.booleans(),
       content_size=st.booleans())
def test_decoders_match_zstandard(data, level, checksum, content_size):
    frame = _compress(data, level, checksum, content_size)
    assert _both(frame) == data == zstandard.ZstdDecompressor().decompress(
        frame, max_output_size=len(data) + 1)


def _fixed_payloads():
    rng = np.random.default_rng(0)
    big = rng.integers(0, 256, 1 << 17, dtype=np.uint8).tobytes()
    offsets = rng.integers(0, len(big) - 300, 700)
    return {
        "skewed_multiblock": (_skewed(rng, 400_000), 1),  # treeless 4-stream literals
        "rle_literals": (big + b"".join(b"z" + big[o:o + 200] for o in offsets), 19),
        "zero_runs": (bytes(300_000), 3),  # RLE blocks
        "short_skewed": (_skewed(rng, 150), 3),  # 1-stream literals
        "random": (rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes(), 1),  # raw blocks
        "floats": (rng.standard_normal(60_000).astype(np.float32).tobytes(), 1),
        "text": (open(plain.__file__, "rb").read() * 8, 19),
    }


@pytest.mark.parametrize("level", LEVELS)
def test_fixed_payloads_reach_every_part_of_the_format(level):
    plain.seen.clear()
    for name, (data, lvl) in _fixed_payloads().items():
        for lv in {lvl, level}:
            for checksum, content_size in ((False, True), (True, False)):
                assert _both(_compress(data, lv, checksum, content_size)) == data, (name, lv)
    want = {"raw_block", "rle_block", "compressed_block", "literals_raw", "literals_rle",
            "literals_huffman", "literals_treeless", "literals_1_stream", "literals_4_stream",
            "huffman_weights_fse", "fse_predefined", "fse_rle", "fse_compressed",
            "fse_repeat", "repeat_offset", "checksum", "content_size", "no_content_size"}
    assert want <= set(plain.seen), sorted(want - set(plain.seen))


def test_streamed_concatenated_and_skippable_frames():
    data = open(plain.__file__, "rb").read() * 5
    buf = io.BytesIO()
    with zstandard.ZstdCompressor(level=3).stream_writer(buf, closefd=False) as w:
        w.write(data)
        w.flush(zstandard.FLUSH_BLOCK)  # a block boundary mid-frame
        w.write(b"tail" * 1000)
    streamed = buf.getvalue()
    assert native.content_size(streamed) == plain.frame_content_size(streamed) == -1
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    two = streamed + skippable + _compress(b"second frame", 1, True)
    assert _both(two) == data + b"tail" * 1000 + b"second frame"


def test_into_a_preallocated_buffer_and_one_too_small():
    data = np.arange(100_000, dtype=np.float32)
    frame = _compress(data.tobytes(), 1)
    out = np.empty_like(data)
    assert native.decompress_into(frame, out) == data.nbytes and np.array_equal(out, data)
    with pytest.raises(ZstdError, match="larger than the destination"):
        native.decompress_into(frame, np.empty(data.size - 1, np.float32))


def test_xxh64_matches_between_decoders():
    rng = np.random.default_rng(1)
    for n in list(range(0, 70)) + [1000, 4099]:
        b = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert native.xxh64(b) == plain.xxh64(b)
        assert native.xxh64(b, 7) == plain.xxh64(b, 7)
    # the frame checksum is XXH64's low 32 bits, as zstandard writes it
    frame = _compress(b"checksummed", 3, checksum=True)
    assert int.from_bytes(frame[-4:], "little") == plain.xxh64(b"checksummed") & 0xFFFFFFFF


def _outcome(fn, frame):
    try:
        return fn(frame)
    except (ZstdError, zstandard.ZstdError):
        return None


@pytest.mark.parametrize("level", [1, 19])
def test_a_flipped_byte_raises_where_zstandard_raises(level):
    rng = np.random.default_rng(level)
    data = _skewed(rng, 20_000) + rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    frame = _compress(data, level, checksum=True)
    ref = zstandard.ZstdDecompressor()
    positions = list(range(0, 16)) + list(rng.integers(16, len(frame), 120)) + list(
        range(len(frame) - 4, len(frame)))
    raised = 0
    for pos in positions:
        for bit in (0, 5):
            bad = bytearray(frame)
            bad[pos] ^= 1 << bit
            bad = bytes(bad)
            theirs = _outcome(lambda f: ref.decompress(f, max_output_size=1 << 20), bad)
            for fn in (native.decompress, plain.decompress):
                ours = _outcome(fn, bad)
                if theirs is None:
                    assert ours is None, (pos, bit, fn)
                else:  # the flip changed nothing that decodes
                    assert ours in (None, data), (pos, bit, fn)
            raised += theirs is None
    assert raised > len(positions)  # most flips are caught
    for pos in range(len(frame) - 4, len(frame)):  # the checksum itself
        bad = bytearray(frame)
        bad[pos] ^= 1
        for fn in (native.decompress, plain.decompress):
            with pytest.raises(ZstdError, match="checksum"):
                fn(bytes(bad))


def test_a_frame_that_names_a_dictionary_raises():
    rng = np.random.default_rng(2)
    samples = [b"sample %d: " % i + _skewed(rng, 200) for i in range(300)]
    d = zstandard.train_dictionary(2048, samples)
    assert d.dict_id() != 0
    frame = zstandard.ZstdCompressor(dict_data=d).compress(samples[0])
    for fn in (native.decompress, plain.decompress):
        with pytest.raises(ZstdError, match="dictionary"):
            fn(frame)
    # a frame that leans on a dictionary it does not name cannot decode either
    raw = zstandard.ZstdCompressionDict(b"a dictionary of sorts " * 20,
                                        dict_type=zstandard.DICT_TYPE_RAWCONTENT)
    frame = zstandard.ZstdCompressor(dict_data=raw).compress(b"a dictionary of sorts, used")
    for fn in (native.decompress, plain.decompress):
        with pytest.raises(ZstdError, match="offset"):
            fn(frame)


def test_every_frame_of_an_orbax_directory(tmp_path):
    """The OCDBT nodes' bodies and every zarr chunk of a checkpoint the JAX
    package's checkpointer writes."""
    from test_torch_orbax import _save, _trees

    from emernerf_torch.train import orbax_read

    path = _save(tmp_path / "ck", {k: v for t in _trees().values() for k, v in
                                   (t.items() if isinstance(t, dict) else [])
                                   if not isinstance(v, dict)})
    frames = []
    for d, _, files in os.walk(path):
        for f in files:
            data = open(os.path.join(d, f), "rb").read()
            if data[:2] == b"\x0c\xdb":  # an OCDBT envelope: version, compression, frame
                frames.append(data[14:-4])
    db = orbax_read.OcdbtReader(path)
    frames += [db.value(v) for k, v in db.items() if not k.endswith(b".zarray")]
    assert len(frames) > 10
    for frame in frames:
        assert frame[:4] == (0xFD2FB528).to_bytes(4, "little")
        assert _both(frame) == zstandard.ZstdDecompressor().decompress(
            frame, max_output_size=1 << 26)
