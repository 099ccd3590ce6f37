"""The benchmark's scene: unchanged, array by array, for the cells that load
no features, and feature maps in the layout of a PCA-reduced DINOv2 map for
a configuration that loads them."""

import hashlib

import numpy as np
import pytest
import torch

from nerfbench import program, scene
from nerfbench.tests import tiny

# sha256 (first 16 hex digits) of each array's dtype, shape and bytes of the
# tiny scenes before the scene could carry feature maps, made on the CPU
DIGEST_TRAIN = {
    "images": "bfe4660e1d1a7f06", "sky_masks": "c99dfb4bfcd4eabd",
    "dynamic_masks": "bda463230c7dfa62", "c2w": "1bf13503b625e04f",
    "intrinsics": "19608a2fe228a406", "frame_idx": "22cb0823b73173c8",
    "cam_ids": "454f411518978ac1", "lidar.origins": "364e65d200511cf2",
    "lidar.viewdirs": "b29895ef3fa502a1", "lidar.ranges": "59d27badd75efe6e",
    "lidar.frame_idx": "a5e7032f69259a67", "aabb": "d1c271f582f1e765",
    "test_image_stride": 0}
DIGEST_EVAL = {
    "images": "8d5d0b642b090189", "sky_masks": "9d323fa1e14d8859",
    "dynamic_masks": "85ac4eda17a6deef", "c2w": "77257c0601fa198a",
    "intrinsics": "9dbcea2307fc556c", "frame_idx": "55d93aa3212f4da5",
    "cam_ids": "57b0bc767519c1e5", "lidar.origins": "91da229debfee3da",
    "lidar.viewdirs": "f58a985e38da64cd", "lidar.ranges": "b05c7f44c2bad8e6",
    "lidar.frame_idx": "f586ef3b1e08ff95", "aabb": "93ea00f7a426471a",
    "test_image_stride": 0}
# a denser patch grid over the tiny image (9 x 15 cells) on 8 frames of the
# front camera, in which the dynamic sphere comes out from behind a static one
MAPS = dict(tiny.TINY_FEATURES, **{"data.pixel_source.feature_extraction_size": [70, 112],
                                   "data.synthetic.num_frames": 8,
                                   "data.pixel_source.num_cams": 1})


def _digest(a) -> str:
    a = np.ascontiguousarray(a)
    return hashlib.sha256(str((a.dtype.str, a.shape)).encode() + a.tobytes()).hexdigest()[:16]


def _digests(s):
    out = {}
    for k, v in s.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": _digest(vv) for kk, vv in v.items()})
        else:
            out[k] = _digest(v) if isinstance(v, np.ndarray) else v
    return out


@pytest.mark.parametrize("cell,want", [("flagship-train", DIGEST_TRAIN),
                                       ("hash-train", DIGEST_TRAIN),
                                       ("flagship-eval", DIGEST_EVAL)])
def test_a_scene_without_features_is_the_one_it_was(cell, want):
    wl, cfg = tiny.tiny_cell(cell)
    s = scene.make_scene(cfg, wl["overrides"], "cpu")
    assert _digests(s) == want
    facts = scene.facts(s)
    assert facts.features is None and facts.tables.features is None


def test_the_patch_grid_of_the_source():
    """DINOv2 ViT-B/14 at 644 x 966 with stride 7: a (91, 137) patch grid,
    the first centre 7 resized pixels from the edge."""
    (hf, wf), (cy, cx) = scene.feature_grid(640, 960, (644, 966), 7)
    assert (hf, wf) == (91, 137) and cy.shape == (91,) and cx.shape == (137,)
    assert float(cy[0]) == pytest.approx(7 * 640 / 644)
    assert float(cx[-1]) == pytest.approx((136 * 7 + 7) * 960 / 966)


def _maps():
    wl, cfg = tiny.tiny_cell("flagship-train", MAPS)
    return wl, cfg, scene.make_scene(cfg, wl["overrides"], "cpu")


def test_the_maps_have_the_patch_grid_and_the_configured_channels():
    wl, cfg, s = _maps()
    f = s["features"]
    assert f.dtype == np.float32 and f.shape == (8, 9, 15, 16)
    assert np.isfinite(f).all()
    facts = scene.facts(s)
    assert facts.features is f and torch.equal(facts.tables.features, torch.from_numpy(f))


def test_the_maps_depend_on_no_seed():
    """Equal over two calls with the global generator at two seeds, and in
    the scene the program gets from two ``--seed``s."""
    wl, cfg = tiny.tiny_cell("flagship-train", MAPS)
    torch.manual_seed(1)
    a = scene.make_scene(cfg, wl["overrides"], "cpu")["features"]
    torch.manual_seed(2)
    b = scene.make_scene(cfg, wl["overrides"], "cpu")["features"]
    assert np.array_equal(a, b)
    _, fa = program.build_trainer(cfg, wl, 2 ** 31 + 3, torch.device("cpu"))
    _, fb = program.build_trainer(cfg, wl, 17, torch.device("cpu"))
    assert np.array_equal(fa.features, a) and np.array_equal(fb.features, a)


def _kinds(f):
    """Each cell's nearest kind embedding: the smooth term is small beside
    the distances between the embeddings."""
    emb, _ = scene.feature_constants(f.shape[-1], "cpu")
    return ((f[..., None, :] - emb.numpy()) ** 2).sum(-1).argmin(-1), emb.numpy()


def test_sky_cells_are_equal():
    _, _, s = _maps()
    kinds, emb = _kinds(s["features"])
    sky = s["features"][kinds == scene.HIT_SKY]
    assert len(sky) > 100 and (sky == emb[scene.HIT_SKY]).all()
    # and nothing else is
    assert not (s["features"][kinds != scene.HIT_SKY] == emb[scene.HIT_SKY]).all(-1).any()


def test_the_maps_move_with_the_dynamic_sphere():
    """Every kind shows, and the dynamic sphere's cells move from frame to
    frame (it crosses the road) and carry other features where they move."""
    _, _, s = _maps()
    f = s["features"]
    kinds, _ = _kinds(f)
    assert set(np.unique(kinds)) == set(range(5))
    dyn = kinds == scene.HIT_DYNAMIC
    frames = [i for i in range(len(f)) if dyn[i].any()]
    assert len(frames) >= 4
    for i, j in zip(frames[:-1], frames[1:]):
        moved = dyn[i] != dyn[j]
        assert moved.any()
        assert (f[i][moved] != f[j][moved]).any(-1).all()
    # the images' own dynamic masks agree that it shows in those frames
    assert all(s["dynamic_masks"][i].any() for i in frames)
