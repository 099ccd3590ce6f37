"""Port parity: emernerf_torch fields against emernerf_tpu fields, eval path,
on the CPU in fp32.

The JAX params come from ``init_train_state`` on the tiny flagship with
fp32 tables and MLPs, go through ``emernerf_torch.convert`` and are loaded
into the port's modules built by ``emernerf_torch.flagship``.  The grid
tables are scaled up from their U(+-1e-4) init so that the encodings, not
the biases, drive the outputs (and the top-K selection of the temporal
aggregation has distinct densities to rank).  Tolerance: rtol 1e-4, atol
1e-5 on every output key, ``agg_mask`` included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emernerf_tpu.flagship import build_flagship as jax_build_flagship
from emernerf_tpu.train.step import init_train_state
from emernerf_torch.builders import validate_cfg
from emernerf_torch.convert import load_jax_params, state_dict_from_jax
from emernerf_torch.flagship import build_flagship, flagship_config

FP32 = ["nerf.model.table_dtype=float32", "nerf.model.mlp_dtype=float32"]
TABLE_SCALE = 2000.0


def _scale_tables(tree):
    return {k: (_scale_tables(v) if isinstance(v, dict)
                else np.asarray(v) * TABLE_SCALE if k.endswith("table") else np.asarray(v))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def pair():
    cfg, dataset, jmodel, jprops, step_cfg = jax_build_flagship(tiny=True, overrides=FP32)
    r = cfg.data.ray_batch_size
    batch = {"origins": jnp.zeros((r, 3)), "normed_timestamps": jnp.zeros((r,)),
             "img_idx": jnp.zeros((r,), jnp.int32), "cam_idx": jnp.zeros((r,), jnp.int32),
             "pixel_coords": jnp.zeros((r, 2))}
    state = jax.jit(lambda key: init_train_state(jmodel, jprops, step_cfg, key, batch))(
        jax.random.PRNGKey(0))
    params = _scale_tables(jax.tree.map(np.asarray, state.params))
    prop_params = tuple(_scale_tables(jax.tree.map(np.asarray, p)) for p in state.prop_params)
    _, _, tmodel, tprops, _ = build_flagship(tiny=True, overrides=FP32)
    load_jax_params(tmodel, tprops, params, prop_params)
    return dict(cfg=cfg, dataset=dataset, jmodel=jmodel, jprops=jprops, params=params,
                prop_params=prop_params, tmodel=tmodel, tprops=tprops)


def _inputs(dataset, r=24, s=6, seed=0):
    rng = np.random.default_rng(seed)
    aabb = dataset.aabb
    lo, hi = aabb[:3], aabb[3:]
    pos = rng.uniform(lo - 0.3 * (hi - lo), hi + 0.3 * (hi - lo), (r, s, 3))
    pos[0] = 1e4  # far outside: zeroed encodings, tied densities
    dirs = rng.normal(size=(r, 1, 3))
    dirs = np.broadcast_to(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True), (r, s, 3))
    data = {
        "normed_timestamps": np.repeat(rng.uniform(0, 1, (r, 1)), s, 1),
        "img_idx": np.repeat(rng.integers(0, dataset.num_images, (r, 1)), s, 1),
        "cam_idx": np.zeros((r, s)),
        "pixel_coords": rng.uniform(0, 1, (r, 2)),
    }
    data = {k: v.astype(np.int32 if k.endswith("idx") else np.float32) for k, v in data.items()}
    return pos.astype(np.float32), np.ascontiguousarray(dirs, np.float32), data


def test_state_dict_names_cover_the_port(pair):
    sd = state_dict_from_jax(pair["params"])
    assert set(sd) == set(pair["tmodel"].state_dict())
    assert sd["rgb_head.layers.1.weight"].shape == pair["tmodel"].rgb_head.layers[1].weight.shape


@pytest.mark.parametrize("level", [0, 1])
def test_density_field_matches_jax(pair, level):
    pos, _, _ = _inputs(pair["dataset"], seed=level)
    ref = jax.jit(pair["jprops"][level].apply)({"params": pair["prop_params"][level]}, pos)
    with torch.no_grad():
        ours = pair["tprops"][level](torch.from_numpy(pos))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("topk", [2, 0], ids=["topk_agg", "all_samples_agg"])
def test_radiance_field_matches_jax(pair, topk):
    jmodel, tmodel = pair["jmodel"], pair["tmodel"]
    jmodel = jmodel.clone(temporal_agg_topk=topk)
    tmodel.temporal_agg_topk = topk
    pos, dirs, data = _inputs(pair["dataset"], seed=7)
    ref = jax.jit(lambda p, x, d, dd: jmodel.apply({"params": p}, x, d, dd, train=False))(
        pair["params"], pos, dirs, data)
    with torch.no_grad():
        ours = tmodel(torch.from_numpy(pos), torch.from_numpy(dirs),
                      {k: torch.from_numpy(v) for k, v in data.items()})
    tmodel.temporal_agg_topk = 2
    assert set(ours) == set(ref)
    if topk:
        assert "agg_mask" in ours and float(ours["agg_mask"].sum()) == topk * pos.shape[0]
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_appearance_mean_embedding_fallback(pair):
    tmodel = pair["tmodel"]
    pos, dirs, data = _inputs(pair["dataset"], seed=3)
    data.pop("img_idx")
    data.pop("cam_idx")
    ref = jax.jit(lambda p, x, d, dd: pair["jmodel"].apply({"params": p}, x, d, dd, train=False))(
        pair["params"], pos, dirs, data)
    with torch.no_grad():
        ours = tmodel(torch.from_numpy(pos), torch.from_numpy(dirs),
                      {k: torch.from_numpy(v) for k, v in data.items()})
    for k in ("static_rgb", "dynamic_rgb", "rgb_sky"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("knob", [
    "nerf.model.grid_backend=hash",
    "nerf.propnet.fine_level_skip=1",
    "render.eval_sample_topk=16",
    "nerf.model.perf.scatter_mode=flat",
    "nerf.model.perf.time_pair=false",
    "nerf.model.fuse_flow_grid=false",
    "nerf.model.head.enable_flow_branch=false",
    "nerf.model.head.enable_feature_head=true",
    "nerf.model.head.direction_encoding=sh",
    "nerf.model.head.enable_temporal_interpolation=true",
])
def test_unported_knob_raises(knob):
    validate_cfg(flagship_config(tiny=True))  # the flagship itself is ported
    with pytest.raises(NotImplementedError):
        validate_cfg(flagship_config(tiny=True, overrides=[knob]))
