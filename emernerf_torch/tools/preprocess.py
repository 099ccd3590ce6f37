"""Waymo Open Dataset preprocessing: TFRecord -> per-scene directory (port
of ``emernerf_tpu/tools/preprocess.py``).

Counterpart of the reference's datasets/waymo_preprocess.py (+ the
preprocess.py entry script): converts raw Waymo scene-flow TFRecords into the
layout the training loader reads (``emernerf_torch/data/waymo.py``).

Per frame it writes: camera jpgs, per-camera intrinsics/extrinsics (once),
4x4 ego pose txts, an Nx14 float32 lidar bin (origin, point, flow,
flow_class, ground, intensity, elongation, laser_id; the reference's
column layout, waymo_preprocess.py:630-699), and dynamic-object masks from
3D boxes moving >1 m/s projected into the cameras
(waymo_preprocess.py:721-818).  Range images are decoded to point clouds in
numpy, including the per-pixel pose compensation for rolling lidar frames
(the reference's compute_range_image_cartesian,
waymo_preprocess.py:96-203); box projection reproduces the configuration
the reference feeds `py_camera_model_ops.world_to_image` (GLOBAL_SHUTTER
metadata + zero velocity/latency, waymo_preprocess.py:74-93) in numpy:
vehicle->camera extrinsics, OpenCV radial-tangential lens distortion from
the 9-coefficient Waymo intrinsics, pinhole scaling
(`project_vehicle_points_to_image`).

TFRecords are read through the dependency-free wire codec
(``emernerf_torch/tools/waymo_wire.py``, framed by the native codec where
it builds).  The original's ``tensorflow`` + ``waymo_open_dataset`` route
is not ported: neither package is on the machines the port runs on.

    python -m emernerf_torch.tools.preprocess --data_root data/waymo/raw \
        --target_dir data/waymo/processed/training --scene_ids 0
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import zlib

import numpy as np

from emernerf_torch.data.utils import get_ground_label
from emernerf_torch.tools import waymo_wire
from emernerf_torch.tools.scene_lists import read_scene_list


# --------------------------------------------------------------------- #
# Scene-flow range-image decoding.
#
# Waymo stores per-return scene flow in a SEPARATE compressed proto field
# (`laser.ri_return{1,2}.range_image_flow_compressed`) that the standard
# `parse_range_image_and_camera_projection` helper never touches — the
# reference decodes it explicitly
# (datasets/waymo_preprocess.py:255-301).  The payload is a
# ZLIB-compressed `MatrixFloat` proto:
#
#   message MatrixFloat { repeated float data = 1 [packed]; MatrixShape shape = 2; }
#   message MatrixShape { repeated int32 dims = 1 [packed]; }
#
# Decoded here with a ~40-line wire-format reader so flow extraction (and
# its tests) need neither tensorflow nor waymo_open_dataset.
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


def _parse_matrix_shape(buf: bytes):
    """MatrixShape: repeated int32 dims = 1."""
    dims = []
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # packed
            ln, i = _read_varint(buf, i)
            end = i + ln
            while i < end:
                v, i = _read_varint(buf, i)
                dims.append(v)
        elif field == 1 and wire == 0:  # unpacked
            v, i = _read_varint(buf, i)
            dims.append(v)
        else:
            raise ValueError(f"unexpected MatrixShape field {field}/{wire}")
    return dims


def parse_matrix_float(buf: bytes):
    """Serialized MatrixFloat -> (np.float32 data, dims list)."""
    data = np.zeros(0, np.float32)
    dims: list = []
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # packed floats
            ln, i = _read_varint(buf, i)
            data = np.frombuffer(buf[i : i + ln], dtype="<f4")
            i += ln
        elif field == 1 and wire == 5:  # single unpacked float
            data = np.concatenate(
                [data, np.frombuffer(buf[i : i + 4], dtype="<f4")]
            )
            i += 4
        elif field == 2 and wire == 2:  # shape submessage
            ln, i = _read_varint(buf, i)
            dims = _parse_matrix_shape(buf[i : i + ln])
            i += ln
        else:
            raise ValueError(f"unexpected MatrixFloat field {field}/{wire}")
    return np.asarray(data, np.float32), dims


def parse_flow_range_images(frame, ri_index: int = 0):
    """Decode every laser's scene-flow range image from a Frame proto.

    Returns {laser_name(1-based): (H, W, 4) float32 [vx, vy, vz, class]},
    empty when the record carries no flow (i.e. it is not from the
    scene-flow bucket).  Counterpart of the reference's
    parse_range_image_flow_and_camera_projection
    (datasets/waymo_preprocess.py:255-301)."""
    flows = {}
    for laser in frame.lasers:
        ret = laser.ri_return1 if ri_index == 0 else laser.ri_return2
        compressed = ret.range_image_flow_compressed
        if len(compressed) == 0:
            continue
        data, dims = parse_matrix_float(zlib.decompress(compressed))
        flows[laser.name] = data.reshape(dims)
    return flows


def _range_image_to_points(range_image, extrinsic, inclination,
                           pixel_pose=None, frame_pose=None):
    """Polar range image -> cartesian points in vehicle (or world) frame.

    range_image: (H, W) ranges; extrinsic: (4,4) lidar->vehicle;
    inclination: (H,) beam inclinations (top row first);
    pixel_pose: optional (H, W, 4, 4) per-pixel vehicle->world poses
    (Waymo's rolling-capture compensation); frame_pose: (4,4).
    """
    h, w = range_image.shape
    # azimuth spans [pi, -pi) across the width, offset by the extrinsic yaw
    az_correction = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    azimuth = np.linspace(np.pi, -np.pi, w, endpoint=False) - az_correction
    az = np.broadcast_to(azimuth[None, :], (h, w))
    incl = np.broadcast_to(inclination[:, None], (h, w))

    x = np.cos(az) * np.cos(incl) * range_image
    y = np.sin(az) * np.cos(incl) * range_image
    z = np.sin(incl) * range_image
    pts = np.stack([x, y, z], axis=-1)  # sensor frame

    # sensor -> vehicle
    pts = pts @ extrinsic[:3, :3].T + extrinsic[:3, 3]

    if pixel_pose is not None and frame_pose is not None:
        # vehicle(at pixel time) -> world -> vehicle(at frame time)
        world = (
            np.einsum("hwij,hwj->hwi", pixel_pose[..., :3, :3], pts)
            + pixel_pose[..., :3, 3]
        )
        inv = np.linalg.inv(frame_pose)
        pts = world @ inv[:3, :3].T + inv[:3, 3]
    return pts


def _box_corners_vehicle(box) -> np.ndarray:
    """Upright 3D box -> (8, 3) corners in the vehicle frame
    (box_utils.get_upright_3d_box_corners semantics)."""
    cx, cy, cz, length, width, height, heading = box
    c, s = np.cos(heading), np.sin(heading)
    corners = np.array(
        [
            [sx * length / 2, sy * width / 2, sz * height / 2]
            for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)
        ]
    )
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return corners @ rot.T + [cx, cy, cz]


def project_vehicle_points_to_image(points, intrinsic, cam_to_vehicle):
    """Waymo global-shutter camera model in numpy.

    The reference projects dynamic boxes with
    ``py_camera_model_ops.world_to_image`` configured with GLOBAL_SHUTTER
    metadata and zeroed velocity/latency (waymo_preprocess.py:74-93), which
    reduces to: vehicle->camera extrinsic, OpenCV radial-tangential lens
    distortion over the x-forward camera frame, pinhole scaling.  Waymo
    intrinsics carry [fx, fy, cx, cy, k1, k2, p1, p2, k3].

    Returns (u, v, ok) arrays; ok is False for points behind the image
    plane (matching the TF op's validity bit for this configuration).
    """
    points = np.asarray(points, np.float64)
    v2c = np.linalg.inv(cam_to_vehicle)
    cam = points @ v2c[:3, :3].T + v2c[:3, 3]
    # camera frame: +x forward (optical axis), +y left, +z up
    xf, yl, zu = cam[:, 0], cam[:, 1], cam[:, 2]
    ok = xf > 1e-6
    xs = np.where(ok, xf, 1.0)
    xn = -yl / xs
    yn = -zu / xs
    fx, fy, cu, cv = intrinsic[:4]
    k1, k2, p1, p2, k3 = (list(intrinsic[4:9]) + [0.0] * 5)[:5]
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    ud = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    vd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    u = fx * ud + cu
    v = fy * vd + cv
    return u, v, ok


def _project_box_to_mask(mask, box, cam_intrinsic, cam_to_vehicle, img_hw,
                         speed: float = np.inf):
    """Max-pool a moving box's projected bounding rect into a float speed
    mask, with the reference's exact skip semantics
    (waymo_preprocess.py:775-810): skip the box if ANY corner projection
    fails; clip to image bounds; skip zero-extent rects."""
    corners = _box_corners_vehicle(box)
    u, v, ok = project_vehicle_points_to_image(
        corners, np.asarray(cam_intrinsic, np.float64), cam_to_vehicle
    )
    if not ok.all():
        return
    h, w = img_hw
    u = np.clip(u, 0, w)
    v = np.clip(v, 0, h)
    if u.max() - u.min() == 0 or v.max() - v.min() == 0:
        return
    v0, v1 = int(v.min()), int(v.min() + (v.max() - v.min()))
    u0, u1 = int(u.min()), int(u.min() + (u.max() - u.min()))
    region = mask[v0:v1, u0:u1]
    np.maximum(region, speed, out=region)


class WaymoProcessor:
    """TFRecord -> preprocessed scene directories
    (waymo_preprocess.py:443-854)."""

    def __init__(self, load_dir: str, save_dir: str, scene_list,
                 scene_names, workers: int = 8, require_flow: bool = True):
        self.load_dir = load_dir
        self.save_dir = save_dir
        self.scene_list = scene_list
        self.scene_names = scene_names
        self.workers = workers
        self.require_flow = require_flow

    def convert(self):
        if self.workers <= 1:
            for i in self.scene_list:
                self.convert_one(i)
        else:
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(self.workers) as pool:
                pool.map(self.convert_one, self.scene_list)

    def convert_one(self, scene_idx: int):
        tfrecord = os.path.join(
            self.load_dir, f"{self.scene_names[scene_idx]}.tfrecord"
        )
        out = os.path.join(self.save_dir, f"{scene_idx:03d}")
        for sub in ("images", "intrinsics", "extrinsics", "ego_pose",
                    "lidar", "dynamic_masks"):
            os.makedirs(os.path.join(out, sub), exist_ok=True)

        for t, rec in enumerate(waymo_wire.read_tfrecords(tfrecord)):
            frame = waymo_wire.parse_frame(rec)
            self._save_images(frame, out, t)
            if t == 0:
                self._save_calib(frame, out)
            self._save_pose(frame, out, t)
            self._save_lidar(frame, out, t, waymo_wire)
            self._save_dynamic_masks(frame, out, t)

    # ------------------------------------------------------------------ #
    @staticmethod
    def _save_images(frame, out, t):
        for img in frame.images:
            cam = img.name - 1  # proto enums are 1-based
            with open(os.path.join(out, "images", f"{t:03d}_{cam}.jpg"), "wb") as f:
                f.write(img.image)

    @staticmethod
    def _save_calib(frame, out):
        for cc in frame.context.camera_calibrations:
            cam = cc.name - 1
            np.savetxt(
                os.path.join(out, "intrinsics", f"{cam}.txt"),
                np.asarray(cc.intrinsic),
            )
            np.savetxt(
                os.path.join(out, "extrinsics", f"{cam}.txt"),
                np.asarray(cc.extrinsic.transform).reshape(4, 4),
            )

    @staticmethod
    def _save_pose(frame, out, t):
        np.savetxt(
            os.path.join(out, "ego_pose", f"{t:03d}.txt"),
            np.asarray(frame.pose.transform).reshape(4, 4),
        )

    def _save_lidar(self, frame, out, t, frame_utils):
        """Decode range images (+ flow) -> world-frame Nx14 bin."""
        (range_images, camera_projections, seg_labels,
         range_image_top_pose) = frame_utils.parse_range_image_and_camera_projection(
            frame
        )
        # scene flow lives in its own compressed field; see
        # parse_flow_range_images.  Records outside the scene-flow bucket
        # have none — refuse by default rather than silently writing zeros.
        flow_images = parse_flow_range_images(frame)
        if not flow_images and self.require_flow:
            raise RuntimeError(
                f"TFRecord frame {t} carries no range_image_flow_compressed "
                "channels. Download scenes from the scene-flow bucket "
                "(gs://waymo_open_dataset_scene_flow) or pass "
                "--allow_no_flow to write zero flows."
            )
        frame_pose = np.asarray(frame.pose.transform).reshape(4, 4)

        all_rows = []
        for calib in frame.context.laser_calibrations:
            laser_id = calib.name - 1
            if calib.name not in range_images:
                continue
            ri = range_images[calib.name][0]  # first return
            ri_np = np.asarray(ri.data, np.float32).reshape(ri.shape.dims)
            rng = ri_np[..., 0]
            intensity = ri_np[..., 1]
            elongation = ri_np[..., 2]

            extrinsic = np.asarray(calib.extrinsic.transform).reshape(4, 4)
            if len(calib.beam_inclinations) == 0:
                incl = np.linspace(
                    calib.beam_inclination_min, calib.beam_inclination_max,
                    rng.shape[0],
                )[::-1]
            else:
                incl = np.asarray(calib.beam_inclinations)[::-1]

            pixel_pose = None
            if laser_id == 0 and range_image_top_pose is not None:
                pp = np.asarray(
                    range_image_top_pose.data, np.float32
                ).reshape(range_image_top_pose.shape.dims)
                # rows: roll, pitch, yaw, x, y, z -> 4x4 per pixel
                pixel_pose = _pose6d_to_mat(pp)

            pts = _range_image_to_points(
                np.maximum(rng, 0.0), extrinsic, incl,
                pixel_pose=pixel_pose, frame_pose=frame_pose,
            )
            valid = rng > 0
            origin = np.broadcast_to(extrinsic[:3, 3], pts.shape)

            # scene flows: velocities (m/s) + class, -1 class = no label
            flow = np.zeros_like(pts)
            flow_class = -np.ones(rng.shape, np.float32)
            if calib.name in flow_images:
                fi_np = flow_images[calib.name]
                if fi_np.shape[:2] != rng.shape:
                    raise RuntimeError(
                        f"flow range image shape {fi_np.shape} does not "
                        f"match range image {rng.shape} for laser "
                        f"{calib.name}"
                    )
                flow = fi_np[..., :3]
                flow_class = fi_np[..., 3]

            rows = np.concatenate(
                [
                    origin[valid],
                    pts[valid],
                    flow[valid],
                    flow_class[valid][:, None],
                    np.zeros((valid.sum(), 1), np.float32),  # ground, below
                    intensity[valid][:, None],
                    elongation[valid][:, None],
                    np.full((valid.sum(), 1), laser_id, np.float32),
                ],
                axis=-1,
            )
            all_rows.append(rows.astype(np.float32))

        data = np.concatenate(all_rows, axis=0)
        # ground labels via plane fit on the vehicle-frame points
        data[:, 10] = get_ground_label(data[:, 3:6]).astype(np.float32)
        data.tofile(os.path.join(out, "lidar", f"{t:03d}.bin"))

    @staticmethod
    def _save_dynamic_masks(frame, out, t):
        from PIL import Image

        # speed max-pooling over projected boxes, thresholded at 1 m/s,
        # with the occlusion filter on lidar point counts
        # (waymo_preprocess.py:721-818)
        labels = list(frame.laser_labels)
        filter_available = any(
            getattr(b, "num_top_lidar_points_in_box", 0) > 0 for b in labels
        )
        candidates = []
        for b in labels:
            if b.box.length * b.box.width * b.box.height == 0:
                continue  # reference: `if not box.ByteSize(): continue`
            top_n = getattr(b, "num_top_lidar_points_in_box", 0)
            any_n = getattr(b, "num_lidar_points_in_box", 0)
            if (filter_available and not top_n) or (
                not filter_available and not any_n
            ):
                continue  # likely occluded
            speed = float(np.hypot(b.metadata.speed_x, b.metadata.speed_y))
            candidates.append(
                (
                    [b.box.center_x, b.box.center_y, b.box.center_z,
                     b.box.length, b.box.width, b.box.height,
                     b.box.heading],
                    speed,
                )
            )
        calibs = {c.name - 1: c for c in frame.context.camera_calibrations}
        for img in frame.images:
            cam = img.name - 1
            cc = calibs[cam]
            h, w = cc.height, cc.width
            speed_mask = np.zeros((h, w), np.float32)
            cam_to_vehicle = np.asarray(cc.extrinsic.transform).reshape(4, 4)
            for box, speed in candidates:
                _project_box_to_mask(
                    speed_mask, box, np.asarray(cc.intrinsic),
                    cam_to_vehicle, (h, w), speed=speed,
                )
            mask = ((speed_mask > 1.0) * 255).astype(np.uint8)
            Image.fromarray(mask).save(
                os.path.join(out, "dynamic_masks", f"{t:03d}_{cam}.png")
            )


def _pose6d_to_mat(pp: np.ndarray) -> np.ndarray:
    """(H, W, 6) [roll, pitch, yaw, x, y, z] -> (H, W, 4, 4)."""
    roll, pitch, yaw = pp[..., 0], pp[..., 1], pp[..., 2]
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    h, w = pp.shape[:2]
    m = np.zeros((h, w, 4, 4), np.float32)
    m[..., 0, 0] = cy * cp
    m[..., 0, 1] = cy * sp * sr - sy * cr
    m[..., 0, 2] = cy * sp * cr + sy * sr
    m[..., 1, 0] = sy * cp
    m[..., 1, 1] = sy * sp * sr + cy * cr
    m[..., 1, 2] = sy * sp * cr - cy * sr
    m[..., 2, 0] = -sp
    m[..., 2, 1] = cp * sr
    m[..., 2, 2] = cp * cr
    m[..., :3, 3] = pp[..., 3:6]
    m[..., 3, 3] = 1.0
    return m


def main(argv=None):
    p = argparse.ArgumentParser("Preprocess Waymo TFRecords")
    p.add_argument("--data_root", default="data/waymo/raw")
    p.add_argument("--target_dir", default="data/waymo/processed/training")
    p.add_argument("--scene_ids", type=int, nargs="+", required=True)
    p.add_argument("--scene_list_file", default="data/waymo_train_list.txt")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument(
        "--allow_no_flow", action="store_true",
        help="write zero flows for records without scene-flow channels "
             "instead of failing",
    )
    args = p.parse_args(argv)

    names = read_scene_list(args.scene_list_file)
    WaymoProcessor(
        args.data_root, args.target_dir, args.scene_ids, names,
        workers=args.workers, require_flow=not args.allow_no_flow,
    ).convert()


if __name__ == "__main__":
    main()
