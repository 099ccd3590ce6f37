"""Port parity: the Waymo loader (``emernerf_torch/data/waymo.py``) against
``emernerf_tpu/data/waymo.py`` on two Waymo-layout scenes written from
numpy: the one of ``tests/test_waymo.py`` (4 frames, one camera, 200
lidar returns of both lasers per frame) with fp16 feature maps added, and
``chip_smoke.py``'s phase 13 scene at a tiny size (three cameras, masks,
feature maps and Occ3D files).  Both loaders run the same numpy code, so
every array is equal exactly: images, masks, poses, intrinsics, lidar,
feature maps after the PCA and the PCA itself, the splits and the aabb.
Also: the features of the training batch and of the eval rays, and what
raises where feature maps are missing (the skip; no card; no hub cache).  The loader's numpy
helpers are held to the originals in ``test_torch_imports``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from emernerf_tpu.config import from_dotlist as jax_from_dotlist
from emernerf_tpu.config import load_config as jax_load_config
from emernerf_tpu.data.waymo import load_waymo_dataset as jax_load_waymo
from emernerf_torch.builders import build_dataset_from_cfg
from emernerf_torch.config import from_dotlist, load_config
from emernerf_torch.data.scene import PixelDraws, sample_pixel_batch
from emernerf_torch.data.waymo import load_waymo_dataset
from emernerf_torch.flagship import DEFAULT_CONFIG

FEAT = (6, 8, 24)  # (Hf, Wf, C) of the feature maps on disk


def write_test_waymo_scene(root):
    """tests/test_waymo.py's fake scene (camera 0, 64x96 JPEGs, 200 returns
    per frame of lasers 0 and 1) plus fp16 feature maps."""
    scene = root / "000"
    for sub in ("images", "intrinsics", "extrinsics", "ego_pose", "lidar", "sky_masks",
                "dynamic_masks", "dinov2_vitb14"):
        (scene / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    np.savetxt(scene / "intrinsics" / "0.txt",
               np.array([2000.0, 2000.0, 960.0, 640.0, 0, 0, 0, 0, 0]))
    cam_to_ego = np.eye(4)
    cam_to_ego[0, 3] = 1.5
    np.savetxt(scene / "extrinsics" / "0.txt", cam_to_ego)
    for t in range(4):
        ego = np.eye(4)
        ego[0, 3] = 100.0 + 2.0 * t
        np.savetxt(scene / "ego_pose" / f"{t:03d}.txt", ego)
        Image.fromarray(rng.uniform(0, 255, (64, 96, 3)).astype(np.uint8)).save(
            scene / "images" / f"{t:03d}_0.jpg")
        Image.fromarray((rng.uniform(0, 1, (64, 96)) > 0.5).astype(np.uint8) * 255).save(
            scene / "sky_masks" / f"{t:03d}_0.png")
        dyn = np.zeros((64, 96), np.uint8)
        dyn[20:40, 10 * t:10 * t + 30] = 255
        Image.fromarray(dyn).save(scene / "dynamic_masks" / f"{t:03d}_0.png")
        n = 200
        pts = np.zeros((n, 14), np.float32)
        pts[:, 3] = rng.uniform(1, 60, n)
        pts[:, 4] = rng.uniform(-20, 20, n)
        pts[:, 5] = rng.uniform(-2, 5, n)
        pts[:, 6:9] = rng.normal(0, 1, (n, 3))
        pts[:, 9] = rng.integers(0, 3, n)
        pts[:, 10] = rng.integers(0, 2, n)
        pts[:, 13] = rng.integers(0, 2, n)
        pts.tofile(scene / "lidar" / f"{t:03d}.bin")
        np.save(scene / "dinov2_vitb14" / f"{t:03d}_0.npy",
                rng.normal(0, 1, FEAT).astype(np.float16))
    return root


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    test_scene = write_test_waymo_scene(tmp_path_factory.mktemp("test_waymo"))
    three = tmp_path_factory.mktemp("three_cams")
    chip_smoke.write_waymo_scene(str(three), n_frames=4, num_cams=3, n_lidar=500,
                                 feat_shape=FEAT, image_hw=(64, 96), occ_voxels=50)
    return {"test_waymo": (test_scene, 1), "three_cams": (three, 3)}


def _overrides(root, num_cams, *more):
    return [f"data.data_root={root}", "data.dataset=waymo", "data.scene_idx=0",
            f"data.pixel_source.num_cams={num_cams}", "data.pixel_source.load_size=[32,48]",
            "data.pixel_source.load_features=true",
            "data.pixel_source.skip_feature_extraction=true",
            "data.pixel_source.target_feature_dim=8", *more]


def _both(root, num_cams, *more):
    over = _overrides(root, num_cams, *more)
    jcfg = jax_load_config(DEFAULT_CONFIG)
    jcfg.merge_(jax_from_dotlist(over))
    cfg = load_config(DEFAULT_CONFIG)
    cfg.merge_(from_dotlist(over))
    return jax_load_waymo(jcfg), load_waymo_dataset(cfg)


_VARIANTS = [("test_waymo", ()), ("test_waymo", ("data.lidar_source.only_use_top_lidar=true",)),
             ("test_waymo", ("data.pixel_source.test_image_stride=2",)),
             ("three_cams", ()), ("three_cams", ("data.start_timestep=1",
                                                 "data.end_timestep=3"))]


@pytest.mark.parametrize("scene,more", _VARIANTS,
                         ids=["test_waymo", "top_lidar", "test_stride", "three_cams", "cut"])
def test_waymo_loader_matches_jax(scenes, scene, more):
    root, cams = scenes[scene]
    ref, ours = _both(root, cams, *more)
    for k in ("images", "sky_masks", "dynamic_masks", "features", "c2w", "intrinsics",
              "frame_idx", "cam_ids", "normed_timestamps", "train_indices", "test_indices",
              "test_frames", "aabb", "ego_to_worlds"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k), err_msg=k)
    assert set(ours.lidar) == set(ref.lidar)
    for k in ref.lidar:
        np.testing.assert_array_equal(ours.lidar[k], ref.lidar[k], err_msg=k)
    for a, b in zip(ours.feat_pca, ref.feat_pca):
        np.testing.assert_array_equal(a, b)
    assert ours.features.shape[-1] == 8 and ours.features.dtype == np.float32
    assert ours.data_path == ref.data_path and ours.occ_voxel_size == ref.occ_voxel_size
    assert ours.num_cams == cams and ours.num_frames == ref.num_frames


def test_eval_rays_and_training_batch_carry_the_features(scenes):
    root, cams = scenes["three_cams"]
    ref, ours = _both(root, cams)
    for downscale in (1, 4):
        _, gt = ours.get_image_rays(2, downscale)
        _, jgt = ref.get_image_rays(2, downscale)
        np.testing.assert_array_equal(gt["features"], jgt["features"])
    scene = ours.scene_tensors("cpu")
    h, w = ours.image_hw
    g = torch.Generator().manual_seed(0)
    draws = PixelDraws(torch.randint(0, len(ours.train_indices), (64,), generator=g),
                       torch.randint(0, w, (64,), generator=g),
                       torch.randint(0, h, (64,), generator=g))
    batch = sample_pixel_batch(scene, draws)
    img = ours.train_indices[draws.img.numpy()]
    fh, fw = ours.features.shape[1:3]
    # the JAX sampler's cell: float32 y * (Hf / H), truncated
    fy = np.asarray(jnp.asarray(draws.y.numpy(), jnp.int32) * (fh / h)).astype(np.int32)
    fx = np.asarray(jnp.asarray(draws.x.numpy(), jnp.int32) * (fw / w)).astype(np.int32)
    np.testing.assert_array_equal(batch["features"].numpy(), ours.features[img, fy, fx])
    assert batch["pixel_coords"].shape == (64, 2)


def test_missing_feature_maps_raise(scenes, tmp_path):
    root, cams = scenes["test_waymo"]
    bare = tmp_path / "bare"
    os.makedirs(bare / "000")
    for sub in os.listdir(root / "000"):
        if sub != "dinov2_vitb14":
            os.symlink(root / "000" / sub, bare / "000" / sub)
    cfg = load_config(DEFAULT_CONFIG)
    cfg.merge_(from_dotlist(_overrides(bare, cams)))
    with pytest.raises(FileNotFoundError, match="skip_feature_extraction"):
        build_dataset_from_cfg(cfg)
    # without the skip the loader extracts the maps: on the card by default,
    # and on the CPU from the torch.hub cache, which this one lacks
    cfg.merge_(from_dotlist(["data.pixel_source.skip_feature_extraction=false"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_dataset_from_cfg(cfg)
    old = torch.hub.get_dir()
    torch.hub.set_dir(str(tmp_path / "empty_hub"))
    try:
        with pytest.raises(RuntimeError, match="no torch.hub cache"):
            build_dataset_from_cfg(cfg, "cpu")
    finally:
        torch.hub.set_dir(old)
    assert not (bare / "000" / "dinov2_vitb14").exists()
