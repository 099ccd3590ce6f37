"""The port's Waymo preprocessor (``emernerf_torch/tools/preprocess.py``)
against ``emernerf_tpu/tools/preprocess.py``: the same hand-encoded
TFRecords go through both ``WaymoProcessor.convert_one`` and the two
scene trees must be byte-identical (JPEGs, intrinsics and extrinsics
text, ego poses, lidar bins, dynamic-mask PNGs).  The records: the
fixture of ``tests/test_waymo_e2e.py`` (3 frames, moving and parked boxes,
flow), the frame of ``tests/test_waymo_schema_conformance.py`` assembled
tag by tag (its blobs are no zlib streams, so both stop at the lidar with
the same error), and a frame assembled with the same emitters and valid
blobs (unpacked beam inclinations, unknown fields, the deprecated range
image, distorted intrinsics, a rolling-shutter pose, the width/length
order of the box).  Also the unit cases of ``tests/test_preprocess.py``
against the port's functions and the CLI's scene-list reader."""

import filecmp
import io
import os
import struct
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import test_waymo_schema_conformance as conf
from PIL import Image
from test_preprocess import _pinhole
from test_preprocess import encode_matrix_float as hand_matrix_float
from test_waymo_e2e import build_fixture_tfrecord

from emernerf_tpu.tools import preprocess as jax_pre
from emernerf_tpu.tools import waymo_wire as jax_ww
from emernerf_torch.tools import preprocess as pre
from emernerf_torch.tools import scene_lists
from emernerf_torch.tools import waymo_wire as ww

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_identical_trees(a, b):
    files = _tree(a)
    assert files == _tree(b)
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    return files


def _convert_both(tmp_path, records, name="seg", require_flow=True):
    raw = tmp_path / "raw"
    raw.mkdir(parents=True)
    ww.write_tfrecords(str(raw / f"{name}.tfrecord"), records)
    outs = {}
    for tag, mod in (("ours", pre), ("ref", jax_pre)):
        outs[tag] = tmp_path / tag
        proc = mod.WaymoProcessor(str(raw), str(outs[tag]), [0], [name], workers=1,
                                  require_flow=require_flow)
        try:
            proc.convert_one(0)
            outs[tag + "_error"] = None
        except Exception as e:  # noqa: BLE001  (both must raise alike)
            outs[tag + "_error"] = (type(e), str(e))
    return outs


def _jpeg(rng, hw=(48, 64)):
    buf = io.BytesIO()
    Image.fromarray(rng.uniform(0, 255, (*hw, 3)).astype(np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def test_e2e_fixture_converts_byte_identically(tmp_path):
    path = tmp_path / "fixture.tfrecord"
    build_fixture_tfrecord(str(path))
    records = list(ww.read_tfrecords(str(path)))
    assert records == list(jax_ww.read_tfrecords(str(path)))
    outs = _convert_both(tmp_path, records)
    assert outs["ours_error"] is None and outs["ref_error"] is None
    files = assert_identical_trees(outs["ours"], outs["ref"])
    for sub in ("images/002_0.jpg", "intrinsics/0.txt", "extrinsics/0.txt",
                "ego_pose/002.txt", "lidar/002.bin", "dynamic_masks/002_0.png"):
        assert os.path.join("000", sub) in files
    mask = np.asarray(Image.open(outs["ours"] / "000" / "dynamic_masks" / "000_0.png"))
    assert mask.shape == (1280, 1920) and 0 < (mask > 0).mean() < 0.5


def test_conformance_frame_stops_at_the_lidar_alike(tmp_path):
    """The conformance frame's range-image blobs are placeholders: both
    packages write the same images, calibration and pose, then raise the
    same error decoding the first blob."""
    outs = _convert_both(tmp_path, [conf.build_frame_bytes()])
    assert outs["ours_error"] is not None and outs["ours_error"] == outs["ref_error"]
    files = assert_identical_trees(outs["ours"], outs["ref"])
    assert {"000/images/000_0.jpg", "000/intrinsics/0.txt", "000/ego_pose/000.txt"} <= set(files)


def _rigid(rng, t):
    a = rng.uniform(-0.3, 0.3)
    m = np.eye(4)
    m[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    m[:3, 3] = t
    return m.reshape(-1).tolist()


def assembled_frame(rng, t, top_pose=True, flow=True):
    """One Frame assembled tag by tag with the conformance test's emitters,
    as build_frame_bytes assembles it, but with valid blobs: a JPEG, the
    TOP lidar's range image of len(BEAMS) rows (with its per-pixel pose),
    the FRONT lidar's (from its inclination limits), their flows, and two
    moving boxes and a parked one."""
    h, w = len(conf.BEAMS), 24
    cam_cal = (conf.varint_field(1, 1) + conf.packed_f64(2, conf.INTRINSIC)
               + conf.ld(3, conf.packed_f64(1, _rigid(rng, [1.5, 0.0, 2.0])))
               + conf.varint_field(4, 1920) + conf.varint_field(5, 1280)
               + conf.varint_field(6, 1))
    top_cal = (conf.varint_field(1, 1) + conf.unpacked_f64(2, conf.BEAMS) + conf.f64(3, -0.31)
               + conf.f64(4, 0.11) + conf.ld(5, conf.packed_f64(1, _rigid(rng, [0.0, 0.0, 2.1]))))
    front_cal = (conf.varint_field(1, 2) + conf.f64(3, -1.2) + conf.f64(4, 0.5)
                 + conf.ld(5, conf.packed_f64(1, _rigid(rng, [4.0, 0.0, 0.6]))))
    context = (conf.ld(1, b"segment-assembled") + conf.ld(2, cam_cal) + conf.ld(3, top_cal)
               + conf.ld(3, front_cal) + conf.ld(4, conf.ld(1, b"weather-sunny")))
    image = (conf.varint_field(1, 1) + conf.ld(2, _jpeg(rng))
             + conf.ld(3, conf.packed_f64(1, np.eye(4).reshape(-1).tolist()))
             + conf.f64(5, 1234.5 + t))

    def ri_blob(rows, cols):
        ri = np.zeros((rows, cols, 4), np.float32)
        ri[..., 0] = rng.uniform(1.0, 70.0, (rows, cols))
        ri[..., 0][rng.uniform(size=(rows, cols)) < 0.25] = -1.0
        ri[..., 1:3] = rng.uniform(0, 1, (rows, cols, 2))
        return zlib.compress(hand_matrix_float(ri, ri.shape))

    def flow_blob(rows, cols):
        fl = rng.normal(0, 2, (rows, cols, 4)).astype(np.float32)
        fl[..., 3] = rng.integers(-1, 3, (rows, cols))
        return zlib.compress(hand_matrix_float(fl, fl.shape))

    def laser(name, rows, cols, pose):
        deprecated = conf.ld(1, struct.pack("<f", 7.5)) + conf.ld(2, conf.varint_field(1, 1))
        ri = conf.ld(1, deprecated) + conf.ld(2, ri_blob(rows, cols))
        if pose:
            pp = np.zeros((rows, cols, 6), np.float32)
            pp[..., :3] = rng.normal(0, 0.01, (rows, cols, 3))
            pp[..., 3] = 50.0 + t + np.linspace(-0.5, 0.5, cols)
            ri += conf.ld(4, zlib.compress(hand_matrix_float(pp, pp.shape)))
        if flow:
            ri += conf.ld(5, flow_blob(rows, cols))
        return conf.varint_field(1, name) + conf.ld(2, ri)

    def label(cx, cy, speed, top_points):
        box = (conf.f64(1, cx) + conf.f64(2, cy) + conf.f64(3, 1.0) + conf.f64(4, 1.8)
               + conf.f64(5, 4.2) + conf.f64(6, 1.5) + conf.f64(7, 0.3))
        return (conf.ld(1, box) + conf.ld(2, conf.f64(1, speed) + conf.f64(2, 0.5))
                + conf.varint_field(3, 1) + conf.ld(4, b"obj") + conf.varint_field(5, 2)
                + conf.varint_field(7, 40) + conf.varint_field(13, top_points))

    pose = np.eye(4)
    pose[0, 3] = 50.0 + t
    return (conf.ld(1, context) + conf.varint_field(2, 1_000_000 * t)
            + conf.ld(3, conf.packed_f64(1, pose.reshape(-1).tolist())) + conf.ld(4, image)
            + conf.ld(5, laser(1, h, w, top_pose)) + conf.ld(5, laser(2, 6, 10, False))
            + conf.ld(6, label(12.0, 0.5, 5.0, 25)) + conf.ld(6, label(25.0, -4.0, 3.0, 9))
            + conf.ld(6, label(18.0, 3.0, 0.0, 12)))


@pytest.mark.parametrize("top_pose", [True, False], ids=["rolling_pose", "no_pose"])
def test_assembled_frames_convert_byte_identically(tmp_path, top_pose):
    rng = np.random.default_rng(7)
    records = [assembled_frame(rng, t, top_pose) for t in range(2)]
    outs = _convert_both(tmp_path, records, name="assembled")
    assert outs["ours_error"] is None and outs["ref_error"] is None
    files = assert_identical_trees(outs["ours"], outs["ref"])
    assert "000/lidar/001.bin" in files and "000/dynamic_masks/001_0.png" in files
    rows = np.fromfile(outs["ours"] / "000" / "lidar" / "000.bin", np.float32).reshape(-1, 14)
    assert set(np.unique(rows[:, 13])) == {0.0, 1.0}  # both lasers
    mask = np.asarray(Image.open(outs["ours"] / "000" / "dynamic_masks" / "000_0.png"))
    assert (mask > 0).any()


def test_flowless_records_raise_alike_and_write_zero_flows_when_allowed(tmp_path):
    rng = np.random.default_rng(8)
    records = [assembled_frame(rng, 0, flow=False)]
    outs = _convert_both(tmp_path / "strict", records)
    assert outs["ours_error"][0] is RuntimeError and outs["ours_error"] == outs["ref_error"]
    outs = _convert_both(tmp_path / "lax", records, require_flow=False)
    assert outs["ours_error"] is None and outs["ref_error"] is None
    assert_identical_trees(outs["ours"], outs["ref"])
    rows = np.fromfile(outs["ours"] / "000" / "lidar" / "000.bin", np.float32).reshape(-1, 14)
    assert (rows[:, 6:9] == 0).all() and (rows[:, 9] == -1).all()


# ----------------------------------------------------------------- #
# tests/test_preprocess.py's unit cases against the port's functions
# ----------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(4, 6, 4), (8, 16, 4), (1, 3, 6)])
def test_parse_matrix_float_roundtrip(shape):
    arr = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    buf = hand_matrix_float(arr, arr.shape)
    data, dims = pre.parse_matrix_float(buf)
    ref_data, ref_dims = jax_pre.parse_matrix_float(buf)
    assert dims == ref_dims == list(shape)
    np.testing.assert_array_equal(data.reshape(dims), arr)
    np.testing.assert_array_equal(data, ref_data)
    # the codec's encoder writes the same bytes as the hand encoder
    assert ww.encode_matrix_float(arr) == buf


def test_parse_flow_range_images_from_stub_frame():
    rng = np.random.default_rng(1)
    flow = rng.normal(size=(8, 16, 4)).astype(np.float32)
    flow[..., 3] = rng.integers(-1, 3, (8, 16)).astype(np.float32)
    compressed = zlib.compress(hand_matrix_float(flow, flow.shape))
    frame = SimpleNamespace(lasers=[
        SimpleNamespace(name=1, ri_return1=SimpleNamespace(range_image_flow_compressed=compressed)),
        SimpleNamespace(name=2, ri_return1=SimpleNamespace(range_image_flow_compressed=b""))])
    flows, ref = pre.parse_flow_range_images(frame), jax_pre.parse_flow_range_images(frame)
    assert set(flows) == set(ref) == {1}  # a laser without flow channels is skipped
    np.testing.assert_array_equal(flows[1], flow)
    np.testing.assert_array_equal(flows[1], ref[1])


def test_flow_required_raises_on_flowless_record():
    proc = pre.WaymoProcessor("/nonexistent", "/nonexistent", [], [], require_flow=True)
    frame = SimpleNamespace(
        lasers=[SimpleNamespace(name=1,
                                ri_return1=SimpleNamespace(range_image_flow_compressed=b""))],
        pose=SimpleNamespace(transform=list(np.eye(4).reshape(-1))))

    class _StubFrameUtils:
        @staticmethod
        def parse_range_image_and_camera_projection(frame):
            return {}, {}, None, None

    with pytest.raises(RuntimeError, match="scene-flow"):
        proc._save_lidar(frame, "/nonexistent", 0, _StubFrameUtils)


@pytest.mark.parametrize("intrinsic", [
    [1200.0, 1180.0, 960.0, 640.0, 0, 0, 0, 0, 0],
    [1200.0, 1200.0, 960.0, 640.0, -0.3, 0.05, 1e-3, -2e-3, 0.01],
    [2055.5, 2055.5, 939.7, 641.1, 0.03, -0.3, 5e-4, -4e-4, 0.0]],
                         ids=["pinhole", "barrel", "waymo"])
def test_camera_model_matches_jax(intrinsic):
    rng = np.random.default_rng(0)
    pts = np.c_[rng.uniform(-10, 40, 64), rng.uniform(-10, 10, 64), rng.uniform(-2, 4, 64)]
    intr = np.array(intrinsic)
    c2v = np.array(_rigid(rng, [1.5, 0.2, 2.0])).reshape(4, 4)
    ours = pre.project_vehicle_points_to_image(pts, intr, c2v)
    ref = jax_pre.project_vehicle_points_to_image(pts, intr, c2v)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert 0 < ours[2].sum() < len(pts)  # points behind the camera are not ok
    if not intr[4:].any():
        u, v = _pinhole(pts[ours[2]], intr, c2v)
        np.testing.assert_allclose(ours[0][ours[2]], u, atol=1e-9)
        np.testing.assert_allclose(ours[1][ours[2]], v, atol=1e-9)


@pytest.mark.parametrize("box,drawn", [([0.5, 0.0, 0.0, 4.0, 2.0, 1.5, 0.0], False),
                                       ([10.0, 0.0, 0.0, 4.0, 2.0, 1.5, 0.0], True),
                                       ([12.0, 3.0, 1.0, 5.0, 2.0, 1.8, 0.3], True),
                                       ([-20.0, 0.0, 0.0, 4.0, 2.0, 1.5, 0.0], False)],
                         ids=["straddles", "ahead", "turned", "behind"])
def test_box_mask_matches_jax(box, drawn):
    intr = np.array([100.0, 100.0, 48.0, 32.0, 0, 0, 0, 0, 0])
    ours, ref = np.zeros((64, 96), np.float32), np.zeros((64, 96), np.float32)
    pre._project_box_to_mask(ours, box, intr, np.eye(4), (64, 96), speed=5.0)
    jax_pre._project_box_to_mask(ref, box, intr, np.eye(4), (64, 96), speed=5.0)
    np.testing.assert_array_equal(ours, ref)
    # a box with a corner behind the camera is skipped; one ahead rasterizes
    assert (ours == 5.0).any() == drawn


def test_pose6d_and_range_image_to_points_match_jax():
    rng = np.random.default_rng(2)
    pp = rng.normal(size=(4, 7, 6)).astype(np.float32)
    np.testing.assert_array_equal(pre._pose6d_to_mat(pp), jax_pre._pose6d_to_mat(pp))
    ri = rng.uniform(0, 50, (4, 7))
    extr = np.array(_rigid(rng, [0.0, 0.0, 2.0])).reshape(4, 4)
    incl = np.linspace(0.1, -0.3, 4)
    frame_pose = np.array(_rigid(rng, [5.0, 1.0, 0.0])).reshape(4, 4)
    for pixel_pose, fp in ((None, None), (pre._pose6d_to_mat(pp), frame_pose)):
        np.testing.assert_array_equal(
            pre._range_image_to_points(ri, extr, incl, pixel_pose, fp),
            jax_pre._range_image_to_points(ri, extr, incl, pixel_pose, fp))


def test_scene_lists_read_the_repositorys_files():
    from emernerf_tpu.tools.download_waymo import read_scene_list, read_split_file

    names = scene_lists.read_scene_list(os.path.join(REPO, "data", "waymo_train_list.txt"))
    assert names == read_scene_list(os.path.join(REPO, "data", "waymo_train_list.txt"))
    assert len(names) > 700 and all(n.startswith("segment-") for n in names[:5])
    for split in ("static32", "dynamic32", "diverse56"):
        path = os.path.join(REPO, "data", "waymo_splits", f"{split}.txt")
        ids = scene_lists.read_split_file(path)
        assert ids == read_split_file(path) and len(ids) == int(split[-2:])


def test_cli_converts_the_listed_scene(tmp_path):
    path = tmp_path / "raw"
    path.mkdir()
    build_fixture_tfrecord(str(path / "fixture-seg-000.tfrecord"), num_frames=1)
    (tmp_path / "list.txt").write_text("other-seg\nfixture-seg-000\n")
    pre.main(["--data_root", str(path), "--target_dir", str(tmp_path / "out"), "--scene_ids", "1",
              "--scene_list_file", str(tmp_path / "list.txt"), "--workers", "1"])
    assert sorted(os.listdir(tmp_path / "out" / "001")) == [
        "dynamic_masks", "ego_pose", "extrinsics", "images", "intrinsics", "lidar"]
    assert os.listdir(tmp_path / "out" / "001" / "lidar") == ["000.bin"]
