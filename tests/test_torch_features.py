"""Port parity of the feature head on the CPU in fp32, against the JAX
package: the tiny flagship (brick grids, fused dynamic+flow grid, sky and
shadow heads) and its static-only form, each with the feature head and
the learnable PE map on, on a Waymo-layout scene with feature maps
(``chip_smoke.write_waymo_scene`` at a tiny size), with JAX's initial
params (grid tables scaled up as in ``test_torch_fields``) converted into
the port's modules:

- ``RadianceField``: every output, ``dino_feat``/``static_dino_feat``/
  ``dynamic_dino_feat``, ``dino_sky_feat`` and ``dino_pe`` included:
  rtol 1e-5, atol 1e-6;
- ``composite_rays`` with the feature channels (the sky feature and the
  PE decomposition, with and without the static/dynamic decomposition):
  outputs rtol 1e-5, atol 1e-5 (sums of 64 weighted fp32 terms in
  another order), and the gradients of a random linear function of every
  output with respect to every input, against ``jax.vjp``: rtol 1e-4,
  atol 1e-5 x the largest |gradient|;
- ``query_attributes`` through the ``PointQueryEngine``s: rtol 1e-5,
  atol 1e-6;
- an eval render of two images and its ``feat_psnr``,
  ``masked_feat_psnr``: the maps rtol 1e-4, atol 1e-5 (as
  ``test_torch_slice``), the metrics rtol 1e-5;
- ``run_occ_eval`` on ``tests/test_occ.py``'s on-disk Occ3D fixture: the
  same centroids (rtol 1e-5, atol 1e-6) and metrics.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fields import _inputs, _make_pair

import chip_smoke
from emernerf_tpu.eval import occ as jax_occ
from emernerf_tpu.eval.points import PointQueryEngine as JaxPointQueryEngine
from emernerf_tpu.eval.renderer import ImageRenderer as JaxImageRenderer
from emernerf_tpu.models.fields import RadianceField as JaxRadianceField
from emernerf_tpu.ops.hashgrid import HashGridSpec as JaxHashGridSpec
from emernerf_tpu.render.volrend import composite_rays as jax_composite
from emernerf_torch.convert import state_dict_from_jax
from emernerf_torch.eval import occ
from emernerf_torch.eval.points import PointQueryEngine
from emernerf_torch.eval.renderer import ImageRenderer
from emernerf_torch.flagship import DEFAULT_PROFILE
from emernerf_torch.models.fields import RadianceField
from emernerf_torch.ops.hashgrid import HashGridSpec
from emernerf_torch.render.volrend import composite_rays

FEAT = (6, 8, 24)  # (Hf, Wf, C) of the feature maps on disk
STATIC_ONLY = ["nerf.model.head.enable_dynamic_branch=false",
               "nerf.model.head.enable_flow_branch=false",
               "nerf.model.head.enable_shadow_head=false"]


def waymo_overrides(root):
    """The tiny flagship on a Waymo-layout scene with the feature head."""
    return [f"data.data_root={root}", "data.dataset=waymo", "data.scene_idx=0",
            "data.pixel_source.num_cams=3", "data.pixel_source.load_size=[16,24]",
            "data.pixel_source.load_features=true",
            "data.pixel_source.skip_feature_extraction=true",
            "data.pixel_source.target_feature_dim=16",
            "nerf.model.head.enable_feature_head=true", "nerf.model.neck.semantic_feature_dim=8",
            "nerf.model.head.feature_mlp_layer_width=16"]


def write_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("waymo")
    chip_smoke.write_waymo_scene(str(root), n_frames=4, num_cams=3, n_lidar=500,
                                 feat_shape=FEAT, image_hw=(64, 96), occ_voxels=50)
    return root


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's parallel workers would oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def waymo_root(tmp_path_factory):
    return write_scene(tmp_path_factory)


@pytest.fixture(scope="module")
def feature_pair(waymo_root):
    return _make_pair(DEFAULT_PROFILE, waymo_overrides(waymo_root))


@pytest.fixture(scope="module")
def static_feature_pair(waymo_root):
    return _make_pair(DEFAULT_PROFILE, waymo_overrides(waymo_root) + STATIC_ONLY)


def test_feature_head_params_carry_across(feature_pair):
    tmodel = feature_pair["tmodel"]
    sd = state_dict_from_jax(feature_pair["params"])
    assert set(sd) == set(tmodel.state_dict())
    assert {"learnable_pe_map", "pe_head.layers.0.weight", "dino_head.layers.2.weight",
            "dino_sky_head.layers.2.weight"} <= set(sd)
    assert tuple(tmodel.learnable_pe_map.shape) == (80, 120, 8)
    # geometry + semantic features out of both base MLPs
    assert tmodel.base_mlp.layers[-1].out_features == 16 + 8
    assert tmodel.dynamic_base_mlp.layers[-1].out_features == 16 + 8
    assert feature_pair["dataset"].features.shape[-1] == 16


@pytest.mark.parametrize("which", ["flagship", "static"])
def test_feature_radiance_field_matches_jax(feature_pair, static_feature_pair, which):
    p = feature_pair if which == "flagship" else static_feature_pair
    pos, dirs, data = _inputs(p["dataset"], seed=4)
    ref = jax.jit(lambda prm, x, d, dd: p["jmodel"].apply({"params": prm}, x, d, dd,
                                                          train=False))(
        p["params"], pos, dirs, data)
    with torch.no_grad():
        ours = p["tmodel"](torch.from_numpy(pos), torch.from_numpy(dirs),
                           {k: torch.from_numpy(v) for k, v in data.items()})
    assert set(ours) == set(ref)
    want = ({"static_dino_feat", "dynamic_dino_feat"} if which == "flagship"
            else {"dino_feat"}) | {"dino_sky_feat", "dino_pe"}
    assert want <= set(ours)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert ours["dino_pe"].shape == (pos.shape[0], 16)


def _feature_outputs(rng, decomposition):
    r, s, f = 40, 64, 16
    t = np.sort(rng.uniform(0.5, 80.0, (r, s + 1)), -1)
    static = rng.exponential(0.05, (r, s))
    static[:3] = 0.0  # empty rays: opacity clipped to 1e-6
    res = {"rgb_sky": rng.uniform(0, 1, (r, 3)), "dino_sky_feat": rng.normal(0, 1, (r, f)),
           "dino_pe": rng.normal(0, 1, (r, f))}
    if decomposition:
        dynamic = rng.exponential(0.02, (r, s))
        res.update(density=static + dynamic, static_density=static, dynamic_density=dynamic,
                   static_rgb=rng.uniform(0, 1, (r, s, 3)),
                   dynamic_rgb=rng.uniform(0, 1, (r, s, 3)),
                   shadow_ratio=rng.uniform(0, 1, (r, s, 1)),
                   static_dino_feat=rng.normal(0, 1, (r, s, f)),
                   dynamic_dino_feat=rng.normal(0, 1, (r, s, f)))
    else:
        res.update(density=static, static_density=static, rgb=rng.uniform(0, 1, (r, s, 3)),
                   dino_feat=rng.normal(0, 1, (r, s, f)))
    res = {k: np.asarray(v, np.float32) for k, v in res.items()}
    return (np.asarray(t[:, :-1], np.float32), np.asarray(t[:, 1:], np.float32), res)


@pytest.mark.parametrize("decomp", [False, True], ids=["static", "decomposition"])
def test_feature_compositing_matches_jax_with_gradients(decomp):
    rng = np.random.default_rng(11 + decomp)
    ts, te, res = _feature_outputs(rng, decomp)
    keys = sorted(res)

    def jax_fn(*vals):
        out = jax_composite(jnp.asarray(ts), jnp.asarray(te), dict(zip(keys, vals)),
                            return_decomposition=decomp)
        out.pop("extras")
        return out

    ref, vjp = jax.vjp(jax_fn, *[jnp.asarray(res[k]) for k in keys])
    inputs = {k: torch.from_numpy(res[k]).requires_grad_(True) for k in keys}
    ours = composite_rays(torch.from_numpy(ts), torch.from_numpy(te), inputs,
                          return_decomposition=decomp)
    ours.pop("extras")
    assert set(ours) == set(ref)
    assert {"dino_feat", "dino_pe", "dino_pe_free"} <= set(ours)
    if decomp:
        assert {"static_dino", "dynamic_dino"} <= set(ours)
    cot = {k: rng.normal(0, 1, np.shape(v)).astype(np.float32) for k, v in ref.items()
           if k != "median_depth"}
    for k in ref:
        if k != "median_depth":
            np.testing.assert_allclose(ours[k].detach().numpy(), np.asarray(ref[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    jgrads = vjp({k: jnp.asarray(cot[k]) if k in cot else jnp.zeros_like(v)
                  for k, v in ref.items()})
    total = sum((ours[k] * torch.from_numpy(c)).sum() for k, c in cot.items())
    tgrads = torch.autograd.grad(total, [inputs[k] for k in keys], allow_unused=True)
    for k, jg, tg in zip(keys, jgrads, tgrads):
        jg = np.asarray(jg)
        tg = np.zeros_like(jg) if tg is None else tg.numpy()
        np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-5 * float(np.abs(jg).max()),
                                   err_msg=k)


@pytest.mark.parametrize("which", ["flagship", "static"])
def test_feature_query_attributes_matches_jax(feature_pair, static_feature_pair, which):
    p = feature_pair if which == "flagship" else static_feature_pair
    rng = np.random.default_rng(9)
    lo, hi = p["dataset"].aabb[:3], p["dataset"].aabb[3:]
    pos = rng.uniform(lo, hi, (700, 3)).astype(np.float32)
    t = rng.uniform(0, 1, 700).astype(np.float32)
    ours = PointQueryEngine(p["tmodel"], chunk_size=256, device="cpu").query_attributes(pos, t)
    ref = JaxPointQueryEngine(p["jmodel"], chunk_size=512).query_attributes(p["params"], pos, t)
    assert set(ours) == set(ref) and "dino_feat" in ours
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_eval_feat_psnr_matches_jax(feature_pair):
    p = feature_pair
    cfg, dataset = p["cfg"], p["dataset"]
    kw = dict(num_samples=cfg.nerf.sampling.num_samples,
              prop_samples=tuple(cfg.nerf.propnet.num_samples_per_prop),
              near_plane=cfg.nerf.propnet.near_plane, far_plane=cfg.nerf.propnet.far_plane,
              sampling_type=cfg.nerf.propnet.sampling_type, chunk_size=192,
              return_decomposition=True)
    frames_ref, ref = JaxImageRenderer(p["jmodel"], p["jprops"], **kw).render_split(
        p["params"], p["prop_params"], dataset, [0, 4])
    frames, ours = ImageRenderer(p["tmodel"], p["tprops"], device="cpu", **kw).render_split(
        dataset, [0, 4])
    assert set(ours) == set(ref) and {"feat_psnr", "masked_feat_psnr"} <= set(ours)
    for k in ref:
        assert np.isclose(ours[k], ref[k], rtol=1e-5), (k, ours[k], ref[k])
    for fr, fr_ref in zip(frames, frames_ref):
        for k in ("dino_feat", "dino_pe", "dino_pe_free", "static_dino", "dynamic_dino"):
            np.testing.assert_allclose(fr[k], fr_ref[k], rtol=1e-4, atol=1e-5, err_msg=k)


def _occ_fixture(tmp_path, num_frames=4):
    """tests/test_occ.py's Occ3D files: 0.4 m grids with 300 labelled
    voxels each (the loader keeps the front half)."""
    occ_dir = tmp_path / "occ3d"
    occ_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(num_frames):
        voxel_label = np.full((200, 200, 16), 23, np.uint8)
        xs, ys, zs = rng.integers(100, 200, 300), rng.integers(0, 200, 300), rng.integers(
            0, 16, 300)
        voxel_label[xs, ys, zs] = rng.integers(0, 15, 300).astype(np.uint8)
        np.savez(occ_dir / f"{i:03d}_04.npz", voxel_label=voxel_label,
                 final_voxel_state=np.ones((200, 200, 16), np.uint8))
    return SimpleNamespace(data_path=str(tmp_path), ego_to_worlds=np.stack([np.eye(4)] * 4),
                           num_frames=num_frames, occ_voxel_size=0.4)


def test_run_occ_eval_matches_jax(tmp_path):
    kw = dict(aabb=(0.0, -40.0, -1.0, 40.0, 40.0, 5.4), geometry_feature_dim=8,
              base_mlp_layer_width=16, head_mlp_layer_width=16, semantic_feature_dim=8,
              enable_feature_head=True, feature_embedding_dim=16, feature_mlp_layer_width=16,
              enable_learnable_pe=False)
    jspec = JaxHashGridSpec(3, 4, 4, 32, 8, 2)
    jmodel = JaxRadianceField(static_spec=jspec, **kw)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 2, 3)), jnp.ones((2, 2, 3)), {})["params"])
    params = {k: (v * 2000.0 if k == "xyz_table" else v) for k, v in params.items()}
    tmodel = RadianceField(static_spec=HashGridSpec(3, 4, 4, 32, 8, 2), **kw)
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    dataset = _occ_fixture(tmp_path)
    engine = PointQueryEngine(tmodel, chunk_size=2048, device="cpu")
    jengine = JaxPointQueryEngine(jmodel, chunk_size=2048)
    ours = occ.run_occ_eval(dataset, engine, annotation_stride=2, density_threshold=0.0)
    ref = jax_occ.run_occ_eval(dataset, jengine, params, annotation_stride=2,
                               density_threshold=0.0)
    assert set(ours) == set(ref) and ours["num_total_points"] > 0
    for k in ("cover_rate", "num_measured_points", "num_total_points"):
        assert ours[k] == ref[k], k
    fn = occ.make_occ_fn(dataset)
    for i in range(4):
        for a, b in zip(fn(i), jax_occ.make_occ_fn(dataset)(i)):
            np.testing.assert_array_equal(a, b)
    c, labels = occ.collect_centroids([0, 2], fn, engine, n_classes=15, feature_dim=16,
                                      density_threshold=0.0)
    jc, jlabels = jax_occ.collect_centroids([0, 2], fn, jengine, params, n_classes=15,
                                            feature_dim=16, density_threshold=0.0)
    np.testing.assert_allclose(c, jc, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(labels, jlabels)
    # the held-out frames' predictions: equal but where the two most similar
    # centroids are within 1e-4 of each other (a near tie that the features'
    # rounding may flip); the accuracies differ by at most those points
    flips, near = 0, 0
    for i in (1, 3):
        coords, _, times = fn(i)
        f = engine.query_attributes(coords, times)["dino_feat"]
        jf = jengine.query_attributes(params, coords, times)["dino_feat"]
        np.testing.assert_allclose(f, jf, rtol=1e-5, atol=1e-6)
        pred = occ.knn_predict(f, c, labels, n_classes=15)
        jpred = jax_occ.knn_predict(jf, jc, jlabels, n_classes=15)
        sim = np.sort((jf / np.linalg.norm(jf, axis=-1, keepdims=True))
                      @ (jc / np.linalg.norm(jc, axis=-1, keepdims=True)).T, -1)
        tie = sim[:, -1] - sim[:, -2] < 1e-4
        assert np.array_equal(pred[~tie], jpred[~tie])
        flips += int((pred != jpred).sum())
        near += int(tie.sum())
    assert flips <= near
    assert abs(ours["micro_accuracy"] - ref["micro_accuracy"]) * ref["num_measured_points"] \
        <= near + 1e-9
