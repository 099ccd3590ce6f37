"""Port parity for the whole eval slice: the tiny flagship scene rendered by
emernerf_tpu's ``ImageRenderer.render_image`` and by the port's, with the
same converted params, on the CPU in fp32; and the same for the tiny
flagship's reference-hash profile (exact hash grids, separate dynamic and
flow grids, every sample flow-warped).

Every map (rgb, depth, opacity, median depth, the static and dynamic
decomposition, shadow and flow) must match with rtol 1e-4, atol 1e-5; the
median depth may move by one sample where cumsum(w) sits within ~1e-6 of
0.5 (see test_torch_volrend.py).  Grid tables are scaled up from their
U(+-1e-4) init so the render is not a constant image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emernerf_tpu import config as jax_config
from emernerf_tpu import flagship as jax_flagship
from emernerf_tpu.eval.renderer import ImageRenderer as JaxImageRenderer
from emernerf_tpu.flagship import build_flagship as jax_build_flagship
from emernerf_tpu.render.renderer import render_ray_batch as jax_render_ray_batch
from emernerf_tpu.train.step import init_train_state
from emernerf_torch.convert import load_jax_params
from emernerf_torch.eval.renderer import ImageRenderer
from emernerf_torch.flagship import DEFAULT_PROFILE, REFERENCE_HASH, build_flagship
from emernerf_torch.render.renderer import render_ray_batch

FP32 = ["nerf.model.table_dtype=float32", "nerf.model.mlp_dtype=float32"]
TABLE_SCALE = 2000.0
MAPS = ("rgb", "depth", "opacity", "static_rgb", "dynamic_rgb", "static_depth",
        "dynamic_depth", "static_opacity", "dynamic_opacity", "shadow_reduced_static_rgb",
        "shadow_only_static_rgb", "shadow", "shadow_ratio", "forward_flow", "backward_flow")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tiny tensors gain little from more, and the
    suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scale_tables(tree):
    return {k: (_scale_tables(v) if isinstance(v, dict)
                else np.asarray(v) * TABLE_SCALE if k.endswith("table") else np.asarray(v))
            for k, v in tree.items()}


def jax_build_profile(profile, overrides):
    """The JAX tiny flagship of a profile: the JAX package's flagship
    dotlist merged over the defaults and the profile's config file."""
    if profile.config_file is None:
        return jax_build_flagship(tiny=True, overrides=list(profile.overrides) + overrides)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_flagship, "load_config",
                  lambda path: jax_config.load_config(path, profile.config_file))
        return jax_build_flagship(tiny=True, overrides=list(profile.overrides) + overrides)


def _render_both(profile=DEFAULT_PROFILE):
    cfg, dataset, jmodel, jprops, step_cfg = jax_build_profile(profile, FP32)
    r = cfg.data.ray_batch_size
    batch = {"origins": jnp.zeros((r, 3)), "normed_timestamps": jnp.zeros((r,)),
             "img_idx": jnp.zeros((r,), jnp.int32), "cam_idx": jnp.zeros((r,), jnp.int32),
             "pixel_coords": jnp.zeros((r, 2))}
    state = jax.jit(lambda key: init_train_state(jmodel, jprops, step_cfg, key, batch))(
        jax.random.PRNGKey(1))
    params = _scale_tables(jax.tree.map(np.asarray, state.params))
    prop_params = tuple(_scale_tables(jax.tree.map(np.asarray, p)) for p in state.prop_params)
    kw = dict(num_samples=cfg.nerf.sampling.num_samples,
              prop_samples=tuple(cfg.nerf.propnet.num_samples_per_prop),
              near_plane=cfg.nerf.propnet.near_plane, far_plane=cfg.nerf.propnet.far_plane,
              sampling_type=cfg.nerf.propnet.sampling_type, chunk_size=160,
              return_decomposition=True)
    img = 1
    rays, gt = dataset.get_image_rays(img)
    ref = JaxImageRenderer(jmodel, jprops, **kw).render_image(params, prop_params, rays, gt["hw"])

    tcfg, tdataset, tmodel, tprops, _ = build_flagship(tiny=True, overrides=FP32,
                                                       profile=profile, device="cpu")
    load_jax_params(tmodel, tprops, params, prop_params)
    trays, tgt = tdataset.get_image_rays(img)
    for k in rays:
        np.testing.assert_array_equal(trays[k], rays[k])
    ours = ImageRenderer(tmodel, tprops, device="cpu", **kw).render_image(trays, tgt["hw"])
    return ours, ref, dict(jmodel=jmodel, jprops=jprops, params=params,
                           prop_params=prop_params, tmodel=tmodel, tprops=tprops,
                           rays=rays, kw=kw)


@pytest.fixture(scope="module")
def renders():
    return _render_both()


@pytest.fixture(scope="module")
def hash_renders():
    return _render_both(REFERENCE_HASH)


@pytest.mark.parametrize("key", MAPS)
def test_slice_map_matches_jax(renders, key):
    ours, ref, _ = renders
    assert ours[key].shape == ref[key].shape
    np.testing.assert_allclose(ours[key], ref[key], rtol=1e-4, atol=1e-5, err_msg=key)


def test_reference_hash_slice_matches_jax(hash_renders):
    ours, ref, m = hash_renders
    assert not m["tmodel"].fused
    for key in MAPS:
        assert ours[key].shape == ref[key].shape
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-4, atol=1e-5, err_msg=key)
    assert np.ptp(ours["rgb"]) > 1e-2 and np.ptp(ours["depth"]) > 1e-2
    a, b = ours["median_depth"].reshape(-1), ref["median_depth"].reshape(-1)
    assert (~np.isclose(a, b, rtol=1e-4, atol=1e-5)).sum() <= max(1, a.size // 100)


def test_slice_median_depth_matches_jax(renders):
    ours, ref, _ = renders
    a, b = ours["median_depth"].reshape(-1), ref["median_depth"].reshape(-1)
    off = ~np.isclose(a, b, rtol=1e-4, atol=1e-5)
    # one-sample moves only, on at most a few pixels
    assert off.sum() <= max(1, a.size // 100), off.sum()


def test_slice_render_is_not_trivial(renders):
    ours, _, _ = renders
    assert np.ptp(ours["rgb"]) > 1e-2 and np.ptp(ours["depth"]) > 1e-2
    assert ours["rgb"].shape == (16, 24, 3)
    for k in MAPS + ("median_depth",):
        assert np.isfinite(ours[k]).all(), k


def test_stratified_batch_with_injected_jitter_matches_jax(renders):
    """Stratified sampling: the port takes the per-level jitter as tensors;
    fed the draws JAX makes from its key, the render matches."""
    _, _, m = renders
    kw = {k: m["kw"][k] for k in ("num_samples", "prop_samples", "near_plane",
                                  "far_plane", "sampling_type", "return_decomposition")}
    rays = {k: v[:96] for k, v in m["rays"].items()}
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p, pp, r, k: jax_render_ray_batch(
        m["jmodel"], p, m["jprops"], pp, r, k, stratified=True, **kw)[0])(
        m["params"], m["prop_params"], rays, key)
    jitters, k = [], key
    for n in (*kw["prop_samples"], kw["num_samples"]):
        k, sub = jax.random.split(k)
        pad = 1.0 / (2 * (n + 1))
        jitters.append(torch.from_numpy(np.array(jax.random.uniform(
            sub, (96, 1), dtype=jnp.float32, minval=-pad, maxval=pad))))
    with torch.no_grad():
        ours = render_ray_batch(m["tmodel"], m["tprops"],
                                {k: torch.from_numpy(np.array(v)) for k, v in rays.items()},
                                jitters=jitters, **kw).out
    for key_ in ("rgb", "depth", "opacity", "static_rgb", "dynamic_rgb", "forward_flow"):
        np.testing.assert_allclose(ours[key_].numpy(), np.asarray(ref[key_]), rtol=1e-4,
                                   atol=1e-5, err_msg=key_)
    # the jitter moved the samples: an unjittered render differs
    with torch.no_grad():
        plain = render_ray_batch(m["tmodel"], m["tprops"],
                                 {k: torch.from_numpy(np.array(v)) for k, v in rays.items()},
                                 **kw).out
    assert not torch.allclose(plain["extras"]["t_vals"], ours["extras"]["t_vals"])


def test_eval_sample_topk_render_matches_jax(renders):
    """``render.eval_sample_topk``: both renderers shade only the K = 3 of 4
    samples per ray that the last proposal net ranks highest (exact top-K,
    then the temporal aggregation's top 2 of those 3) and scatter the
    outputs back; every map within the slice's tolerance, and the pruned
    render differs from the exact one."""
    exact, _, m = renders
    kw = dict(m["kw"], sample_topk=3)
    rays, hw = m["rays"], exact["rgb"].shape[:2]
    ref = JaxImageRenderer(m["jmodel"], m["jprops"], **kw).render_image(
        m["params"], m["prop_params"], rays, hw)
    ours = ImageRenderer(m["tmodel"], m["tprops"], device="cpu", **kw).render_image(rays, hw)
    for key in MAPS:
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-4, atol=1e-5, err_msg=key)
    assert not np.allclose(ours["rgb"], exact["rgb"], rtol=1e-4, atol=1e-5)
