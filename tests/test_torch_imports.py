"""Package boundary of the port: emernerf_torch never imports jax, flax,
optax, the JAX package emernerf_tpu or the repository's perf/ scripts, its
own copies of the JAX package's framework-free modules (config, synthetic
scene, metrics, data utils, visualization, the video frames, the novel
trajectory's cameras and rays, the lidar projection of the data preview)
and the feature path's numpy helpers (the PCA of the feature maps, the PE
map's bilinear sampler, the deletion of the maps) agree with the
originals, its flagship config is the JAX package's, and its entry points
run on the card unless asked for the CPU."""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emernerf_tpu import config as jax_config
from emernerf_tpu import flagship as jax_flagship
from emernerf_tpu.builders import build_dataset_from_cfg as jax_build_dataset
from emernerf_tpu.data import synthetic as jax_synthetic
from emernerf_tpu.data import utils as jax_data_utils
from emernerf_tpu.data.waymo import reduce_features_pca as jax_reduce_features_pca
from emernerf_tpu.eval import data_preview as jax_data_preview
from emernerf_tpu.eval import metrics as jax_metrics
from emernerf_tpu.eval import novel as jax_novel
from emernerf_tpu.eval import video as jax_video
from emernerf_tpu.ops.interp import grid_sample_2d as jax_grid_sample_2d
from emernerf_tpu.tools.extract_features import delete_features as jax_delete_features
from emernerf_tpu.utils import visualization as jax_visualization
from emernerf_torch import config, flagship
from emernerf_torch.builders import build_dataset_from_cfg
from emernerf_torch.data import synthetic
from emernerf_torch.data import utils as data_utils
from emernerf_torch.data.waymo import reduce_features_pca
from emernerf_torch.eval import data_preview, metrics, novel, video
from emernerf_torch.ops.interp import grid_sample_2d
from emernerf_torch.tools.extract_features import delete_features
from emernerf_torch.utils import visualization
from emernerf_torch.flagship import REFERENCE_HASH, flagship_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# and the repository's perf/ scripts (the TPU probes the port counterparts);
# and what the JAX package's checkpoints are written with (the card's machine
# has none of them: the port reads those directories on its own)
_BLOCKED = ("jax", "jaxlib", "flax", "optax", "emernerf_tpu", "perf", "orbax", "tensorstore",
            "zstandard")
_FIXTURE = os.path.join(REPO, "tests", "data", "jax_orbax_tiny", "checkpoint_00100")


def test_every_module_imports_without_jax():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        blocked = {_BLOCKED!r}
        for name in blocked:
            sys.modules[name] = None  # any import of them raises
        import emernerf_torch
        names = [m.name for m in pkgutil.walk_packages(emernerf_torch.__path__, "emernerf_torch.")]
        for name in names:
            importlib.import_module(name)
        from emernerf_torch.train.orbax_read import read_jax_train_state
        assert read_jax_train_state({_FIXTURE!r})["step"] == 100  # a JAX checkpoint, read
        leaked = [m for m in sys.modules if m.split(".")[0] in blocked
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print(" ".join(names))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    walked = set(out.stdout.split())
    assert len(walked) >= 20  # every module was walked
    assert {"emernerf_torch.ops.gather_scatter", "emernerf_torch.perf.pallas_experiments",
            "emernerf_torch.perf.bench_scatter_alts", "emernerf_torch.train.checkpoints",
            "emernerf_torch.train_emernerf", "emernerf_torch.utils.logging",
            "emernerf_torch.data.utils", "emernerf_torch.utils.visualization",
            "emernerf_torch.eval.points", "emernerf_torch.eval.flow",
            "emernerf_torch.eval.video", "emernerf_torch.eval.novel",
            "emernerf_torch.eval.data_preview", "emernerf_torch.eval.voxel_vis",
            "emernerf_torch.data.waymo", "emernerf_torch.ops.interp",
            "emernerf_torch.eval.occ", "emernerf_torch.ops.sh", "emernerf_torch.data.nuscenes",
            "emernerf_torch.data.nuscenes_devkit_lite", "emernerf_torch.native",
            "emernerf_torch.tools.preprocess", "emernerf_torch.tools.waymo_wire",
            "emernerf_torch.tools.scene_lists", "emernerf_torch.tools.extract_features",
            "emernerf_torch.tools.vit_extractor", "emernerf_torch.parallel",
            "emernerf_torch.parallel.mesh", "emernerf_torch.parallel.spmd",
            "emernerf_torch.perf.northstar_report", "emernerf_torch.perf.quality_ab",
            "emernerf_torch.perf.quality_report", "emernerf_torch.native.zstd",
            "emernerf_torch.native.zstd_plain", "emernerf_torch.train.orbax_read"} <= walked


@pytest.mark.parametrize("tiny", [True, False])
def test_flagship_config_equals_jax(tiny):
    assert flagship_config(tiny=tiny).to_dict() == jax_flagship.flagship_config(tiny=tiny).to_dict()


def jax_profile_config(tiny, overrides=()):
    """The JAX flagship config of the reference-hash profile: the JAX
    package's flagship dotlist merged over the defaults and the profile's
    config file, as the CLI merges them."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_flagship, "load_config",
                  lambda path: jax_config.load_config(path, REFERENCE_HASH.config_file))
        return jax_flagship.flagship_config(tiny, list(REFERENCE_HASH.overrides) + list(overrides))


@pytest.mark.parametrize("profile", ["default", "flagship", "reference_hash", "reference_hash_tiny"])
def test_config_copy_equals_jax(profile):
    dot = ["data.dataset=synthetic", "nerf.model.head.enable_flow_branch=true"]
    cases = {
        "default": (None, []),
        "flagship": (None, dot),
        "reference_hash": (REFERENCE_HASH.config_file, dot + list(REFERENCE_HASH.overrides)),
    }
    if profile == "reference_hash_tiny":
        ours, ref = flagship_config(tiny=True, profile=REFERENCE_HASH), jax_profile_config(True)
        assert ours.nerf.model.grid_backend == "hash" and ours.nerf.model.fuse_flow_grid is False
    else:
        cfile, dots = cases[profile]
        ours = config.load_config(flagship.DEFAULT_CONFIG, cfile, dots)
        ref = jax_config.load_config(jax_flagship.DEFAULT_CONFIG, cfile, dots)
    assert ours.to_dict() == ref.to_dict()
    assert ours.to_yaml() == ref.to_yaml()


def test_synthetic_scene_copy_equals_jax():
    cfg = flagship_config()
    syn = cfg.data.synthetic
    kw = dict(num_frames=syn.num_frames, num_cams=cfg.data.pixel_source.num_cams,
              hw=(syn.image_height, syn.image_width), dynamic=syn.dynamic)
    ours, ref = synthetic.make_synthetic_scene(**kw), jax_synthetic.make_synthetic_scene(**kw)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(ref[k]), err_msg=k)


def test_metrics_copy_equals_jax():
    rng = np.random.default_rng(0)
    a, b = rng.uniform(0, 1, (2, 24, 32, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (24, 32)) > 0.5
    assert metrics.compute_psnr(a, b) == jax_metrics.compute_psnr(a, b)
    ours, ref = metrics.compute_ssim(a, b, full=True), jax_metrics.compute_ssim(a, b, full=True)
    assert ours[0] == ref[0]
    np.testing.assert_array_equal(ours[1], ref[1])
    assert metrics.compute_psnr(a[mask], b[mask]) == jax_metrics.compute_psnr(a[mask], b[mask])
    depth, gt = rng.uniform(0, 50, (2, 500))
    gt[::3] = 0.0  # rays without a return
    assert (metrics.compute_valid_depth_rmse(depth, gt)
            == jax_metrics.compute_valid_depth_rmse(depth, gt))
    flow, labels = rng.normal(size=(2, 300, 3))
    assert (metrics.compute_scene_flow_metrics(flow, labels)
            == jax_metrics.compute_scene_flow_metrics(flow, labels))
    names = sorted(n for n in dir(jax_metrics) if n.startswith("compute_"))
    assert names == sorted(n for n in dir(metrics) if n.startswith("compute_"))


def test_data_utils_copy_equals_jax():
    rng = np.random.default_rng(1)
    aabb_min, aabb_max, res = [-3.0, -2.0, 0.0], [5.0, 4.0, 2.5], [7, 5, 3]
    np.testing.assert_array_equal(data_utils.voxel_coords_to_world_coords(aabb_min, aabb_max, res),
                                  jax_data_utils.voxel_coords_to_world_coords(aabb_min, aabb_max,
                                                                              res))
    pts = rng.uniform(0, 5, (50, 3))
    np.testing.assert_array_equal(
        data_utils.voxel_coords_to_world_coords(aabb_min, aabb_max, res, pts),
        jax_data_utils.voxel_coords_to_world_coords(aabb_min, aabb_max, res, pts))
    np.testing.assert_array_equal(
        data_utils.world_coords_to_voxel_coords(pts, aabb_min, aabb_max, res),
        jax_data_utils.world_coords_to_voxel_coords(pts, aabb_min, aabb_max, res))
    for seed in range(4):  # rotations of every trace sign (Shepperd's branches)
        q = np.random.default_rng(seed).normal(size=(2, 4))
        t1, t2 = np.eye(4), np.eye(4)
        t1[:3, :3], t2[:3, :3] = data_utils._quat_to_mat(q[0]), data_utils._quat_to_mat(q[1])
        t1[:3, 3], t2[:3, 3] = rng.normal(size=(2, 3))
        for alpha in (0.0, 0.3, 1.0):
            np.testing.assert_array_equal(data_utils.interpolate_matrices(t1, t2, alpha),
                                          jax_data_utils.interpolate_matrices(t1, t2, alpha))
    s = synthetic.make_synthetic_scene(num_frames=3, num_cams=1, hw=(8, 12), dynamic=True)
    lidar = s["lidar_origins"] + s["lidar_viewdirs"] * s["lidar_ranges"][:, None]
    ground = data_utils.get_ground_label(lidar)
    np.testing.assert_array_equal(ground, jax_data_utils.get_ground_label(lidar))
    assert 0 < ground.sum() < len(ground)


def test_turbo_table_is_matplotlibs():
    """The port's turbo table is matplotlib's, bit for bit, and indexed as
    matplotlib's ListedColormap indexes it (both ends, bin edges, out of
    range, NaN)."""
    from matplotlib import colormaps

    lut = colormaps["turbo"]
    assert lut.N == len(visualization._TURBO) == 256
    np.testing.assert_array_equal(visualization._TURBO, lut(np.arange(256))[:, :3])
    x = np.concatenate([np.random.default_rng(0).uniform(-0.2, 1.2, 19998), np.arange(257) / 256,
                        np.nextafter(np.arange(1, 257) / 256, 0), [np.nan, 0.0, 1.0, 0.5]])
    np.testing.assert_array_equal(visualization._turbo(x), lut(x)[:, :3])
    grid = x[:len(x) // 5 * 5].reshape(-1, 5)  # a 2D map, as depth_visualizer passes
    np.testing.assert_array_equal(visualization._turbo(grid), lut(grid)[..., :3])


def _frame(rng, h=12, w=16):
    return {"gt_rgb": rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
            "rgb": rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
            "depth": rng.uniform(0.5, 80, (h, w)).astype(np.float32),
            "opacity": rng.uniform(0, 1, (h, w)).astype(np.float32),
            "forward_flow": rng.normal(size=(h, w, 3)).astype(np.float32),
            "dynamic_opacity": rng.uniform(0, 1, (h, w)).astype(np.float32)}


def test_visualization_copy_equals_jax():
    rng = np.random.default_rng(2)
    f = _frame(rng)
    np.testing.assert_array_equal(visualization.depth_visualizer(f["depth"], f["opacity"]),
                                  jax_visualization.depth_visualizer(f["depth"], f["opacity"]))
    np.testing.assert_array_equal(visualization.depth_visualizer(f["depth"], lo=2.0, hi=40.0),
                                  jax_visualization.depth_visualizer(f["depth"], lo=2.0, hi=40.0))
    for bg in ("dark", "bright"):
        np.testing.assert_array_equal(
            visualization.scene_flow_to_rgb(f["forward_flow"], background=bg),
            jax_visualization.scene_flow_to_rgb(f["forward_flow"], background=bg))
    feats = rng.normal(size=(300, 8))
    ours, ref = visualization.get_robust_pca(feats), jax_visualization.get_robust_pca(feats)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(visualization.apply_pca_colors(feats, *ours),
                                  jax_visualization.apply_pca_colors(feats, *ref))
    np.testing.assert_array_equal(visualization.to_uint8(f["rgb"] * 1.2 - 0.1),
                                  jax_visualization.to_uint8(f["rgb"] * 1.2 - 0.1))


def test_video_frames_copy_equals_jax():
    """compose_frame: rgb, a depth map colored with the opacity, flow, a
    scalar map and a key the frame lacks."""
    f = _frame(np.random.default_rng(3))
    keys = ["gt_rgb", "rgb", "depth", "forward_flow", "dynamic_opacity", "backward_flow"]
    ours = video.compose_frame(f, keys)
    assert ours.dtype == np.uint8 and ours.shape == (5 * 12, 16, 3)
    np.testing.assert_array_equal(ours, jax_video.compose_frame(f, keys))


@pytest.fixture(scope="module")
def datasets():
    """The port's and the JAX package's tiny flagship scene, with a test
    split (frame 0 of 3)."""
    dot = ["data.pixel_source.test_image_stride=2"]
    return (build_dataset_from_cfg(flagship_config(tiny=True, overrides=dot)),
            jax_build_dataset(jax_flagship.flagship_config(tiny=True, overrides=dot)))


def test_dataset_eval_surface_equals_jax(datasets):
    """The lidar flow labels and ground mask, the training timesteps and
    the lidar visibility that the flow eval and the voxel export read."""
    ours, ref = datasets
    assert set(ours.lidar) == set(ref.lidar)
    for k in ref.lidar:
        np.testing.assert_array_equal(ours.lidar[k], ref.lidar[k], err_msg=k)
    assert ours.num_train_timesteps == ref.num_train_timesteps == 1
    np.testing.assert_array_equal(ours.unique_normalized_training_timestamps,
                                  ref.unique_normalized_training_timestamps)
    for frame in range(ref.num_frames):
        pts = ref.get_lidar_render_rays(frame)
        pts = pts["origins"] + pts["viewdirs"] * pts["ranges"][:, None]
        vis = ours.get_valid_lidar_mask(frame, pts)
        np.testing.assert_array_equal(vis, ref.get_valid_lidar_mask(frame, pts))
        assert 0 < vis.sum() < len(vis)


def test_novel_trajectory_copy_equals_jax(datasets):
    ours, ref = datasets
    cams, ref_cams = novel.generate_novel_trajectory(ours), jax_novel.generate_novel_trajectory(ref)
    assert len(cams) == len(ref_cams) == 5
    for a, b in zip(cams, ref_cams):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    c = cams[3]
    rays = novel._rays_for_camera(c["c2w"], c["intrinsics"], (6, 8), c["normed_timestamp"])
    ref_rays = jax_novel._rays_for_camera(c["c2w"], c["intrinsics"], (6, 8), c["normed_timestamp"])
    assert set(rays) == set(ref_rays)
    for k in ref_rays:
        np.testing.assert_array_equal(rays[k], ref_rays[k], err_msg=k)


def test_data_preview_projection_copy_equals_jax(datasets):
    ours, ref = datasets
    for img in range(ref.num_images):
        (depth, flow), (ref_depth, ref_flow) = (data_preview.project_lidar_to_image(ours, img),
                                                jax_data_preview.project_lidar_to_image(ref, img))
        np.testing.assert_array_equal(depth, ref_depth)
        np.testing.assert_array_equal(flow, ref_flow)
        assert depth.any()


def test_reduce_features_pca_matches_jax():
    feats = np.random.default_rng(3).normal(size=(3, 5, 7, 20)).astype(np.float32)
    for a, b in zip(reduce_features_pca(feats, 6, sample=50),
                    jax_reduce_features_pca(feats, 6, sample=50)):
        np.testing.assert_array_equal(a, b)


def test_grid_sample_2d_matches_jax_bit_for_bit():
    rng = np.random.default_rng(5)
    image = rng.normal(size=(7, 11, 5)).astype(np.float32)
    # inside, on the edges and corners, and out of range on every side
    g = np.concatenate([rng.uniform(-1, 1, (200, 2)), rng.uniform(-3, 3, (200, 2)),
                        np.array([[-1, -1], [1, 1], [-1, 1], [1, -1], [0, 0], [1.2, -1.3]])]
                       ).astype(np.float32)
    ours = grid_sample_2d(torch.from_numpy(image), torch.from_numpy(g[:, 0]),
                          torch.from_numpy(g[:, 1])).numpy()
    ref = np.asarray(jax_grid_sample_2d(jnp.asarray(image), jnp.asarray(g[:, 0]),
                                        jnp.asarray(g[:, 1])))
    np.testing.assert_array_equal(ours, ref)
    # and the semantics of F.grid_sample (bilinear, align_corners=False, zeros)
    lib = torch.nn.functional.grid_sample(
        torch.from_numpy(image).permute(2, 0, 1)[None], torch.from_numpy(g)[None, None],
        mode="bilinear", padding_mode="zeros", align_corners=False)[0, :, 0].T
    np.testing.assert_allclose(ours, lib.numpy(), rtol=1e-5, atol=1e-6)


def test_delete_features_matches_the_jax_tool(tmp_path):
    for d in ("ours", "ref"):
        os.makedirs(tmp_path / d)
        for name in ("000_0.npy", "001_1.npy", "keep.txt"):
            (tmp_path / d / name).write_bytes(b"x")
    delete_features(str(tmp_path / "ours"))
    jax_delete_features(str(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "ref")) == [
        "keep.txt"]


def test_spmd_config_copy_equals_jax():
    """The data-parallel settings: SpmdConfig's fields and defaults, the bf16
    moment threshold and the ZeRO routing rule are the JAX package's."""
    import dataclasses

    from emernerf_torch.parallel import spmd
    from emernerf_torch.train import optim
    from emernerf_tpu.parallel import spmd as jax_spmd
    from emernerf_tpu.train import optim as jax_optim

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(spmd.SpmdConfig) == fields(jax_spmd.SpmdConfig)
    assert optim._BF16_MOMENT_MIN_ELEMS == jax_optim._BF16_MOMENT_MIN_ELEMS
    assert spmd.SpmdConfig().zero_min_elems == jax_spmd.SpmdConfig().zero_min_elems
    for shape in [(8, 64), (9, 64), (2,), (4, 3, 2), ()]:
        for n, min_elems in [(2, 1), (2, 512), (4, 64), (3, 24)]:
            assert spmd._is_big(shape, n, min_elems) == jax_spmd._is_big(
                jnp.zeros(shape), n, min_elems), (shape, n, min_elems)

