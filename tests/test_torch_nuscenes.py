"""Port parity: the nuScenes loader (``emernerf_torch/data/nuscenes.py``) and
its table reader (``emernerf_torch/data/nuscenes_devkit_lite.py``) against
``emernerf_tpu/data/nuscenes{,_devkit_lite}.py`` on the JAX tests'
fixtures (the cached metas of ``tests/test_nuscenes.py``, the devkit
layout of ``tests/test_nuscenes_devkit.py``, the documented records of
``tests/test_nuscenes_schema_conformance.py``) and on a tiny
``chip_smoke.write_nuscenes_scene``: the metas JSON-identical, every array
of the dataset equal (images, masks, feature maps and their PCA, lidar
exactly; poses to 1e-12), the cached-meta reload without the tables, the
``end_timestep`` fraction of the lidar chain, the sky-mask and feature
paths, and 2 CLI iterations on the tiny scene.  The reader is held to
its original as a copy.  Also: the eval's ground-truth maps keep the
rendered pixels where the image is not a multiple of the downscale (the
JAX package keeps one row more there, and its metrics fail to broadcast)."""

import inspect
import json
import os
import shutil

import numpy as np
import pytest
import torch
from test_nuscenes import nusc_fixture  # noqa: F401 (a fixture)
from test_nuscenes_devkit import build_devkit_layout
from test_nuscenes_schema_conformance import doc_tables

import chip_smoke
from emernerf_tpu.config import from_dotlist as jax_from_dotlist
from emernerf_tpu.config import load_config as jax_load_config
from emernerf_tpu.data import nuscenes as jax_nuscenes
from emernerf_tpu.data import nuscenes_devkit_lite as jax_lite
from emernerf_torch.config import from_dotlist, load_config
from emernerf_torch.data import nuscenes, nuscenes_devkit_lite
from emernerf_torch.flagship import DEFAULT_CONFIG

_ARRAYS = ("images", "sky_masks", "features", "frame_idx", "cam_ids", "normed_timestamps",
           "train_indices", "test_indices", "test_frames", "aabb", "lidar_normed_timestamps")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(root, *more):
    over = ["data.dataset=nuscenes", f"data.data_root={root}", "data.scene_idx=0",
            "data.lidar_source.truncated_max_range=80",
            "data.lidar_source.truncated_min_range=-2", *more]
    ours, ref = load_config(DEFAULT_CONFIG), jax_load_config(DEFAULT_CONFIG)
    ours.merge_(from_dotlist(over))
    ref.merge_(jax_from_dotlist(over))
    return ours, ref


def assert_same_dataset(ours, ref):
    for k in _ARRAYS:
        a, b = getattr(ours, k, None), getattr(ref, k, None)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("c2w", "intrinsics"):
        np.testing.assert_allclose(getattr(ours, k), getattr(ref, k), rtol=0, atol=1e-12,
                                   err_msg=k)
    assert (ours.lidar is None) == (ref.lidar is None)
    if ref.lidar is not None:
        assert set(ours.lidar) == set(ref.lidar)
        for k in ref.lidar:
            np.testing.assert_array_equal(ours.lidar[k], ref.lidar[k], err_msg=k)
    assert (ours.feat_pca is None) == (ref.feat_pca is None)
    for a, b in zip(ours.feat_pca or (), ref.feat_pca or ()):
        np.testing.assert_array_equal(a, b)
    assert ours.scene_fraction == ref.scene_fraction
    assert (ours.num_frames, ours.num_cams) == (ref.num_frames, ref.num_cams)


def _walk_both(root, *more):
    """Both packages' metas, each from its own token walk over ``root``
    (the cache cleared between), and both datasets."""
    cfg, jcfg = _cfgs(root, *more)
    cache = os.path.join(root, "emernerf_metas")
    shutil.rmtree(cache, ignore_errors=True)
    metas = nuscenes.create_or_load_metas(cfg)
    files = {n: open(os.path.join(cache, n)).read() for n in sorted(os.listdir(cache))}
    shutil.rmtree(cache)
    jmetas = jax_nuscenes.create_or_load_metas(jcfg)
    assert files == {n: open(os.path.join(cache, n)).read() for n in sorted(os.listdir(cache))}
    assert json.dumps(metas) == json.dumps(jmetas)
    return (nuscenes.load_nuscenes_from_meta(*metas, cfg),
            jax_nuscenes.load_nuscenes_from_meta(*jmetas, jcfg), cfg)


@pytest.mark.parametrize("more", [(), ("data.end_timestep=1",), ("data.start_timestep=1",),
                                  ("data.pixel_source.num_cams=1",)],
                         ids=["all", "end_timestep", "start_timestep", "one_camera"])
def test_loader_matches_jax_on_cached_metas(nusc_fixture, more):  # noqa: F811
    """test_nuscenes.py's cached metas (CAM_FRONT a frame longer than the
    others; the lidar chain twice as long)."""
    cfg, jcfg = _cfgs(nusc_fixture, "data.pixel_source.num_cams=3",
                      "data.pixel_source.load_size=[16,24]", *more)
    ours, ref = nuscenes.load_nuscenes_dataset(cfg), jax_nuscenes.load_nuscenes_dataset(jcfg)
    assert_same_dataset(ours, ref)
    assert ours.sky_masks is not None and ours.lidar is not None


def test_loader_matches_jax_on_the_devkit_layout(tmp_path):
    """test_nuscenes_devkit.py's tables: the token walk of both packages
    through their table readers, then the datasets."""
    build_devkit_layout(tmp_path / "nusc")
    ours, ref, _ = _walk_both(str(tmp_path / "nusc"), "data.nuscenes_version=v1.0-mini",
                              "data.pixel_source.num_cams=3",
                              "data.pixel_source.load_size=[24,32]",
                              "data.pixel_source.load_sky_mask=false")
    assert_same_dataset(ours, ref)
    assert ours.images.shape == (9, 24, 32, 3) and len(ours.lidar["ranges"]) > 0


def test_meta_walk_matches_jax_on_documented_records(tmp_path):
    """The documented schema's records through both readers and both walks."""
    tdir = tmp_path / "v1.0-mini"
    tdir.mkdir()
    for name, records in doc_tables().items():
        (tdir / f"{name}.json").write_text(json.dumps(records))
    ours = nuscenes_devkit_lite.NuScenesLite("v1.0-mini", str(tmp_path))
    ref = jax_lite.NuScenesLite("v1.0-mini", str(tmp_path))
    assert json.dumps(ours._tables) == json.dumps(ref._tables)  # reverse index included
    scene, jscene = ours.scene[0], ref.scene[0]
    assert (json.dumps(nuscenes.build_camera_meta(ours, scene))
            == json.dumps(jax_nuscenes.build_camera_meta(ref, jscene)))
    assert (json.dumps(nuscenes.build_lidar_meta(ours, scene))
            == json.dumps(jax_nuscenes.build_lidar_meta(ref, jscene)))


def test_lite_reader_is_a_copy():
    assert nuscenes_devkit_lite.TABLES == jax_lite.TABLES
    assert (inspect.getsource(nuscenes_devkit_lite.NuScenesLite)
            == inspect.getsource(jax_lite.NuScenesLite))
    for name in ("CAMERA_LISTS", "ALL_CAMERAS"):
        assert getattr(nuscenes, name) == getattr(jax_nuscenes, name)
    np.testing.assert_array_equal(nuscenes.OPENCV2DATASET, jax_nuscenes.OPENCV2DATASET)


def test_feature_and_sky_mask_paths_match_jax():
    for path in ("samples/CAM_FRONT/a.jpg", "sweeps/CAM_BACK/n0__CAM_BACK__1.jpg"):
        assert nuscenes._sky_mask_path(path) == jax_nuscenes._sky_mask_path(path)
        assert (nuscenes._feature_path(path, "dinov2_vitb14")
                == jax_nuscenes._feature_path(path, "dinov2_vitb14"))
    assert nuscenes._sky_mask_path("samples/CAM_FRONT/a.jpg") == "samples_sky_mask/CAM_FRONT/a.png"
    assert (nuscenes._feature_path("sweeps/CAM_FRONT/a.jpg", "dinov2_vitb14")
            == "sweeps_dinov2_vitb14/CAM_FRONT/a.npy")


@pytest.fixture(scope="module")
def smoke_scene(tmp_path_factory):
    """chip_smoke's nuScenes scene at a tiny size: 4 frames per camera (the
    chains 4, 5 and 6 long), 36x64 JPEGs, 300 returns per sweep, fp16
    feature maps."""
    root = str(tmp_path_factory.mktemp("smoke_nusc"))
    return chip_smoke.write_nuscenes_scene(root, n_frames=4, image_hw=(36, 64), n_lidar=300,
                                           feat_shape=(6, 8, 24))


@pytest.mark.parametrize("more", [
    (), ("data.end_timestep=1",), ("data.pixel_source.num_cams=3", "data.start_timestep=1"),
    ("data.pixel_source.load_features=true", "data.pixel_source.target_feature_dim=8")],
    ids=["six_cameras", "end_timestep", "three_cameras_start", "features"])
def test_loader_matches_jax_on_the_smoke_scene(smoke_scene, more):
    ours, ref, cfg = _walk_both(smoke_scene, "data.pixel_source.num_cams=6",
                                "data.pixel_source.load_size=[18,32]", *more)
    assert_same_dataset(ours, ref)
    cams = cfg.data.pixel_source.num_cams
    assert ours.num_cams == cams and ours.sky_masks is not None
    n_total = len(json.load(open(os.path.join(
        smoke_scene, "emernerf_metas", "scene_000_lidar.json")))["timestamp"])
    # the lidar keeps the cameras' fraction of its own chain
    frames = ours.num_frames
    assert ours.scene_fraction == frames / 4
    if "data.pixel_source.load_features=true" in more:
        assert ours.features.shape == (6 * 4, 6, 8, 8) and ours.feat_pca is not None
    else:
        assert ours.features is None
    end = int(n_total * ours.scene_fraction)
    start = min(cfg.data.start_timestep, end - 1)
    assert len(ours.lidar["ranges"]) <= (end - start) * 300


def test_cached_metas_reload_without_the_tables(smoke_scene, tmp_path):
    """The second load reads the cached metas: with the tables gone it
    gives the same dataset."""
    root = tmp_path / "copy"
    shutil.copytree(smoke_scene, root)
    shutil.rmtree(root / "emernerf_metas", ignore_errors=True)
    cfg, _ = _cfgs(root, "data.pixel_source.num_cams=6", "data.pixel_source.load_size=[18,32]")
    first = nuscenes.load_nuscenes_dataset(cfg)
    assert sorted(os.listdir(root / "emernerf_metas")) == ["scene_000_camera.json",
                                                          "scene_000_lidar.json"]
    shutil.rmtree(root / "v1.0-trainval")
    assert_same_dataset(nuscenes.load_nuscenes_dataset(cfg), first)


def test_cli_trains_two_iterations_on_the_smoke_scene(smoke_scene, tmp_path):
    """python -m emernerf_torch.train_emernerf on the tiny flagship with
    data.dataset=nuscenes and six cameras: 2 iterations (optim.num_iters=1
    runs steps 0 and 1), then the
    evaluation (lowres split and the lidar depth)."""
    from emernerf_torch.flagship import _FLAGSHIP_DOTLIST, _TINY_DOTLIST
    from emernerf_torch.train_emernerf import main

    argv = (["--device", "cpu", "--output_root", str(tmp_path), "--project", "p",
             "--run_name", "nusc"] + list(_FLAGSHIP_DOTLIST) + list(_TINY_DOTLIST)
            + ["data.dataset=nuscenes", f"data.data_root={smoke_scene}",
               "data.pixel_source.num_cams=6", "data.pixel_source.load_size=[18,32]",
               "optim.num_iters=1", "render.render_full=false", "render.render_chunk_size=576",
               "logging.print_freq=1"])
    trainer = main(argv)
    assert trainer.state.step == 2 and trainer.dataset.num_cams == 6
    run_dir = tmp_path / "p" / "nusc"
    results = json.loads((run_dir / "metrics_all_2.json").read_text())
    for k in ("lowres/psnr", "lidar/depth_rmse"):
        assert np.isfinite(results[k]), k
    records = [json.loads(x) for x in (run_dir / "metrics.json").read_text().splitlines()]
    assert records and all(np.isfinite(v) for v in records[-1].values()
                           if isinstance(v, float))


def test_eval_maps_keep_the_rendered_pixels(smoke_scene):
    """18 rows at downscale 4: 4 rendered rows, and the ground-truth maps
    keep those 4 (the JAX package's keep 5); at sizes that are multiples
    of the downscale the maps are the JAX package's."""
    ours, ref, _ = _walk_both(smoke_scene, "data.pixel_source.load_size=[18,32]",
                              "data.pixel_source.num_cams=6")
    for downscale in (1, 2, 4):
        rays, gt = ours.get_image_rays(3, downscale)
        jrays, jgt = ref.get_image_rays(3, downscale)
        hh, ww = gt["hw"]
        assert (hh, ww) == jgt["hw"] == (18 // downscale, 32 // downscale)
        assert len(rays["origins"]) == hh * ww
        for k in ("pixels", "sky_masks"):
            assert gt[k].shape[:2] == (hh, ww), k
            np.testing.assert_array_equal(gt[k], jgt[k][:hh, :ww], err_msg=k)
        for k in rays:
            np.testing.assert_array_equal(rays[k], jrays[k], err_msg=k)
    assert ref.get_image_rays(3, 4)[1]["pixels"].shape[0] == 5
