"""Raw TFRecord to a trained model in the port, on the CPU, against the JAX
package: ``tests/test_waymo_e2e.py``'s hand-encoded fixture goes through
the port's ``WaymoProcessor.convert_one`` and the JAX one; with the feature
maps missing, the port's ``load_waymo_dataset(..., device="cpu")`` and the
JAX loader extract them on demand from the same ``torch.hub`` directory (a
tiny ViT of DINOv2's layout that ``chip_smoke.write_hubconf`` writes): the
maps are equal bit for bit and the loaded arrays within 1e-6;
``skip_feature_extraction=true`` still raises; then the port's CLI trains
a few steps on the fixture and extracts the maps itself.  No network: the
hub's lookup of the repository's branch gets an error at once (the JAX
loader names the repository without one), and the port loads the cached
repository with ``source="local"``.  No JAX training step is compiled."""

import json
import os
import shutil
import urllib.error

import numpy as np
import pytest
import torch
from test_waymo_e2e import NUM_FRAMES, build_fixture_tfrecord

import chip_smoke
from emernerf_tpu.config import from_dotlist as jax_from_dotlist
from emernerf_tpu.config import load_config as jax_load_config
from emernerf_tpu.data.waymo import load_waymo_dataset as jax_load_waymo
from emernerf_tpu.tools.preprocess import WaymoProcessor as JaxWaymoProcessor
from emernerf_torch.config import from_dotlist, load_config
from emernerf_torch.data.waymo import load_waymo_dataset
from emernerf_torch.flagship import _FLAGSHIP_DOTLIST, _TINY_DOTLIST, DEFAULT_CONFIG
from emernerf_torch.tools.preprocess import WaymoProcessor

FEAT_HW = (42, 56)  # feature_extraction_size: a (5, 7) token grid at stride 7
MAPS = "dinov2_vitb14"


@pytest.fixture(scope="module", autouse=True)
def offline_hub(tmp_path_factory):
    """A torch.hub directory holding the tiny model, restored after; any
    URL the hub would open raises at once."""
    hub = tmp_path_factory.mktemp("hub")
    chip_smoke.write_hubconf(str(hub), **chip_smoke.TINY_HUB)
    old_dir, old_urlopen = torch.hub.get_dir(), torch.hub.urlopen
    threads = torch.get_num_threads()

    calls = []

    def offline(*args, **kwargs):
        calls.append(args)
        raise urllib.error.URLError("no network in the tests")

    torch.hub.set_dir(str(hub))
    torch.hub.urlopen = offline
    torch.set_num_threads(1)
    yield calls
    torch.hub.set_dir(old_dir)
    torch.hub.urlopen = old_urlopen
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The fixture record converted by the port (``ours``) and by the JAX
    package (``ref``), each in a root of its own, no feature maps."""
    root = tmp_path_factory.mktemp("waymo_e2e")
    raw = root / "raw"
    raw.mkdir()
    build_fixture_tfrecord(str(raw / "fixture-seg-000.tfrecord"))
    out = {}
    for tag, proc in (("ours", WaymoProcessor), ("ref", JaxWaymoProcessor)):
        out[tag] = root / tag
        proc(str(raw), str(out[tag]), [0], ["fixture-seg-000"], workers=1).convert_one(0)
    return out


def _overrides(root, *more):
    return [f"data.data_root={root}", "data.dataset=waymo", "data.scene_idx=0",
            "data.pixel_source.num_cams=1", "data.pixel_source.load_size=[32,48]",
            "data.pixel_source.load_sky_mask=false", "data.pixel_source.load_features=true",
            "data.pixel_source.skip_feature_extraction=false",
            f"data.pixel_source.feature_extraction_size=[{FEAT_HW[0]},{FEAT_HW[1]}]",
            "data.pixel_source.target_feature_dim=8", *more]


def _cfg(root, *more, jax=False):
    cfg = (jax_load_config if jax else load_config)(DEFAULT_CONFIG)
    cfg.merge_((jax_from_dotlist if jax else from_dotlist)(_overrides(root, *more)))
    return cfg


def test_loader_extracts_missing_maps_as_jax(scenes, offline_hub):
    del offline_hub[:]
    ours = load_waymo_dataset(_cfg(scenes["ours"]), device="cpu")
    assert not offline_hub  # the port opened no URL
    ref = jax_load_waymo(_cfg(scenes["ref"], jax=True))
    assert offline_hub  # the JAX loader's lookup of the branch was stopped
    names = sorted(os.listdir(scenes["ours"] / "000" / MAPS))
    assert names == sorted(os.listdir(scenes["ref"] / "000" / MAPS)) == [
        f"{t:03d}_0.npy" for t in range(NUM_FRAMES)]
    for name in names:
        a = np.load(scenes["ours"] / "000" / MAPS / name)
        b = np.load(scenes["ref"] / "000" / MAPS / name)
        assert a.dtype == np.float16 and a.shape == (5, 7, chip_smoke.TINY_HUB["dim"])
        assert np.isfinite(a).all() and a.tobytes() == b.tobytes()
    for k in ("images", "dynamic_masks", "features", "c2w", "intrinsics", "frame_idx",
              "cam_ids", "aabb", "ego_to_worlds"):
        np.testing.assert_allclose(getattr(ours, k), getattr(ref, k), rtol=0, atol=1e-6,
                                   err_msg=k)
    assert ours.features.shape == (NUM_FRAMES, 5, 7, 8) and ours.sky_masks is None
    for k in ref.lidar:
        np.testing.assert_allclose(ours.lidar[k], ref.lidar[k], rtol=0, atol=1e-6, err_msg=k)
    for a, b in zip(ours.feat_pca, ref.feat_pca):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_existing_maps_are_kept_and_skip_raises(scenes, tmp_path):
    """A scene with every map extracts nothing (the maps are not rewritten);
    one without maps and skip_feature_extraction=true raises."""
    maps = scenes["ours"] / "000" / MAPS
    if not maps.is_dir():
        load_waymo_dataset(_cfg(scenes["ours"]), device="cpu")
    mtimes = {f: os.stat(maps / f).st_mtime_ns for f in os.listdir(maps)}
    load_waymo_dataset(_cfg(scenes["ours"]), device="cpu")
    assert {f: os.stat(maps / f).st_mtime_ns for f in os.listdir(maps)} == mtimes
    bare = tmp_path / "bare"
    shutil.copytree(scenes["ours"], bare, ignore=shutil.ignore_patterns("*.npy"))
    with pytest.raises(FileNotFoundError, match="skip_feature_extraction"):
        load_waymo_dataset(_cfg(bare, "data.pixel_source.skip_feature_extraction=true"),
                           device="cpu")
    assert not list((bare / "000" / MAPS).glob("*.npy"))


def test_extract_cli_writes_the_loaders_maps(scenes, tmp_path):
    """python -m emernerf_torch.tools.extract_features on the CPU at the
    loader's size: the maps the loader extracted, bit for bit."""
    from emernerf_torch.tools import extract_features

    maps = scenes["ours"] / "000" / MAPS
    if not maps.is_dir():
        load_waymo_dataset(_cfg(scenes["ours"]), device="cpu")
    scene = tmp_path / "000"
    shutil.copytree(scenes["ours"] / "000", scene, ignore=shutil.ignore_patterns("*.npy"))
    extract_features.main(["--data_path", str(scene), "--device", "cpu",
                           "--height", str(FEAT_HW[0]), "--width", str(FEAT_HW[1])])
    names = sorted(os.listdir(scene / MAPS))
    assert names == sorted(os.listdir(maps))
    for name in names:
        assert np.load(scene / MAPS / name).tobytes() == np.load(maps / name).tobytes()


def test_cli_trains_on_the_preprocessed_fixture(scenes, tmp_path):
    """The port's CLI on the converted fixture (the tiny flagship with the
    feature head): the loader extracts the maps on the CPU, 2 iterations,
    the evaluation with feat_psnr, the maps deleted."""
    from emernerf_torch.train_emernerf import main

    root = tmp_path / "scene"
    shutil.copytree(scenes["ours"], root, ignore=shutil.ignore_patterns("*.npy"))
    trainer = main(["--device", "cpu", "--output_root", str(tmp_path), "--project", "p",
                    "--run_name", "e2e"] + list(_FLAGSHIP_DOTLIST) + list(_TINY_DOTLIST)
                   + _overrides(root, "nerf.model.head.enable_feature_head=true",
                                "nerf.model.neck.semantic_feature_dim=8",
                                "nerf.model.head.feature_mlp_layer_width=16",
                                "render.render_full=false", "optim.num_iters=1",
                                "logging.print_freq=1",
                                "data.pixel_source.delete_features_after_run=true"))
    run_dir = tmp_path / "p" / "e2e"
    assert trainer.state.step == 2 and trainer.step_cfg.use_feature_loss
    assert trainer.dataset.features.shape == (NUM_FRAMES, 5, 7, 8)
    records = [json.loads(x) for x in (run_dir / "metrics.json").read_text().splitlines()]
    assert np.isfinite(records[-1]["feature_loss"]) and np.isfinite(records[-1]["rgb_loss"])
    results = json.loads((run_dir / "metrics_all_2.json").read_text())
    assert np.isfinite(results["lowres/feat_psnr"]) and np.isfinite(results["lowres/psnr"])
    assert not list((root / "000" / MAPS).glob("*.npy"))
