"""Port parity: emernerf_torch fields against emernerf_tpu fields, eval path,
on the CPU in fp32: the tiny flagship (brick grids, fused dynamic+flow
grid), its reference-hash profile (exact hash grids, separate dynamic and
flow grids), its brick profile with unfused grids, the dynamic-only profile
(``configs/default_dynamic.yaml``: no flow) and the reference-semantics
profile on brick grids (separate dynamic and flow grids of unpaired 4D
rows, every sample flow-warped); and the flagship with spherical-harmonics
directions (rtol 1e-5).  The eval-time temporal interpolation is held in
``test_torch_interpolation.py`` on this file's pairs.

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

from emernerf_tpu import config as jax_config
from emernerf_tpu import flagship as jax_flagship
from emernerf_tpu.flagship import build_flagship as jax_build_flagship
from emernerf_tpu.train.step import init_train_state
from emernerf_torch.builders import validate_cfg
from emernerf_torch.convert import load_jax_params, state_dict_from_jax
from emernerf_torch.flagship import (
    DEFAULT_PROFILE,
    DYNAMIC,
    REFERENCE_BRICK,
    REFERENCE_HASH,
    build_flagship,
    flagship_config,
)
from emernerf_torch.ops.brickgrid import BrickGridSpec
from emernerf_torch.ops.hashgrid import HashGridSpec

FP32 = ["nerf.model.table_dtype=float32", "nerf.model.mlp_dtype=float32"]
TABLE_SCALE = 2000.0


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


def _make_pair(profile=DEFAULT_PROFILE, overrides=()):
    overrides = FP32 + list(overrides)
    cfg, dataset, jmodel, jprops, step_cfg = jax_build_profile(profile, overrides)
    r = cfg.data.ray_batch_size
    batch = {"origins": jnp.zeros((r, 3)), "normed_timestamps": jnp.zeros((r,)),
             "img_idx": jnp.zeros((r,), jnp.int32), "cam_idx": jnp.zeros((r,), jnp.int32),
             "pixel_coords": jnp.zeros((r, 2))}
    state = jax.jit(lambda key: init_train_state(jmodel, jprops, step_cfg, key, batch))(
        jax.random.PRNGKey(0))
    params = _scale_tables(jax.tree.map(np.asarray, state.params))
    prop_params = tuple(_scale_tables(jax.tree.map(np.asarray, p)) for p in state.prop_params)
    tcfg, _, tmodel, tprops, _ = build_flagship(tiny=True, overrides=overrides,
                                                 profile=profile, device="cpu")
    assert tcfg.to_dict() == cfg.to_dict()
    load_jax_params(tmodel, tprops, params, prop_params)
    return dict(cfg=cfg, dataset=dataset, jmodel=jmodel, jprops=jprops, params=params,
                prop_params=prop_params, tmodel=tmodel, tprops=tprops)


@pytest.fixture(scope="module")
def pair():
    return _make_pair()


@pytest.fixture(scope="module")
def hash_pair():
    return _make_pair(REFERENCE_HASH)


@pytest.fixture(scope="module")
def unfused_pair():
    return _make_pair(overrides=["nerf.model.fuse_flow_grid=false"])


@pytest.fixture(scope="module")
def dynamic_pair():
    return _make_pair(DYNAMIC)


@pytest.fixture(scope="module")
def reference_brick_pair():
    return _make_pair(REFERENCE_BRICK)


def _radiance_matches(p, seed, topk=None, rtol=1e-4):
    jmodel, tmodel = p["jmodel"], p["tmodel"]
    if topk is not None:
        jmodel = jmodel.clone(temporal_agg_topk=topk)
        tmodel.temporal_agg_topk = topk
    pos, dirs, data = _inputs(p["dataset"], seed=seed)
    ref = jax.jit(lambda prm, x, d, dd: jmodel.apply({"params": prm}, x, d, dd, train=False))(
        p["params"], pos, dirs, data)
    with torch.no_grad():
        ours = tmodel(torch.from_numpy(pos), torch.from_numpy(dirs),
                      {k: torch.from_numpy(v) for k, v in data.items()})
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=rtol,
                                   atol=1e-5, err_msg=k)
    return ours, pos


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
    ours, pos = _radiance_matches(pair, 7, topk)
    pair["tmodel"].temporal_agg_topk = 2
    if topk:
        assert "agg_mask" in ours and float(ours["agg_mask"].sum()) == topk * pos.shape[0]


def test_reference_hash_state_dict_names(hash_pair):
    tmodel = hash_pair["tmodel"]
    sd = state_dict_from_jax(hash_pair["params"])
    assert set(sd) == set(tmodel.state_dict())
    assert {"xyz_table", "dynamic_table", "flow_table"} <= set(sd) and "dynflow_table" not in sd
    assert not tmodel.fused and tmodel.temporal_agg_topk == 0
    for name in ("static_spec", "dynamic_spec", "flow_spec"):
        spec = getattr(tmodel, name)
        assert isinstance(spec, HashGridSpec)
        assert tuple(getattr(tmodel, name.replace("spec", "table").replace("static", "xyz"))
                     .shape) == spec.table_shape  # feature-major (F, L*T)
    for pm in hash_pair["tprops"]:
        assert isinstance(pm.spec, HashGridSpec) and pm.hash_table.shape == pm.spec.table_shape


@pytest.mark.parametrize("level", [0, 1])
def test_reference_hash_density_field_matches_jax(hash_pair, level):
    pos, _, _ = _inputs(hash_pair["dataset"], seed=20 + level)
    ref = jax.jit(hash_pair["jprops"][level].apply)({"params": hash_pair["prop_params"][level]},
                                                   pos)
    with torch.no_grad():
        ours = hash_pair["tprops"][level](torch.from_numpy(pos))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_reference_hash_radiance_field_matches_jax(hash_pair):
    ours, _ = _radiance_matches(hash_pair, 8)
    assert "agg_mask" not in ours  # every sample is flow-warped


def test_brick_unfused_radiance_field_matches_jax(unfused_pair):
    tmodel = unfused_pair["tmodel"]
    assert not tmodel.fused and tmodel.temporal_agg_topk == 0
    assert set(state_dict_from_jax(unfused_pair["params"])) == set(tmodel.state_dict())
    _radiance_matches(unfused_pair, 9)


def test_dynamic_only_radiance_field_matches_jax(dynamic_pair):
    """The dynamic grid alone: no flow grid, flow MLP or aggregation; the
    JAX tree carries across unchanged."""
    tmodel = dynamic_pair["tmodel"]
    assert tmodel.has_dynamic and not tmodel.has_flow and not tmodel.fused
    sd = state_dict_from_jax(dynamic_pair["params"])
    assert set(sd) == set(tmodel.state_dict())
    assert "dynamic_table" in sd and not any(k.startswith(("flow", "dynflow")) for k in sd)
    ours, _ = _radiance_matches(dynamic_pair, 10)
    assert {"dynamic_rgb", "shadow_ratio", "dynamic_density"} <= set(ours)
    assert not {"forward_flow", "backward_flow", "agg_mask"} & set(ours)


def test_reference_brick_radiance_field_matches_jax(reference_brick_pair):
    """Separate dynamic and flow brick grids of unpaired 4D rows, every
    sample flow-warped."""
    tmodel = reference_brick_pair["tmodel"]
    assert not tmodel.fused and tmodel.temporal_agg_topk == 0
    for spec in (tmodel.dynamic_spec, tmodel.flow_spec):
        assert isinstance(spec, BrickGridSpec) and spec.has_time and not spec.uses_time_pair
    assert tmodel.dynamic_table.shape == tmodel.dynamic_spec.table_shape
    assert set(state_dict_from_jax(reference_brick_pair["params"])) == set(tmodel.state_dict())
    ours, _ = _radiance_matches(reference_brick_pair, 11)
    assert "forward_flow" in ours and "agg_mask" not in ours


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
    "nerf.model.grid_backend=mx",
    "nerf.propnet.fine_level_skip=1",
    "nerf.model.perf.scatter_mode=flat",
    "nerf.model.perf.gather_mode=1d",
    "nerf.model.head.enable_dynamic_branch=false",  # the flow branch stays on
    "nerf.model.perf.reduce_mode=einsum",
])
def test_unported_knob_raises(knob):
    validate_cfg(flagship_config(tiny=True))  # the flagship itself is ported
    with pytest.raises(NotImplementedError):
        validate_cfg(flagship_config(tiny=True, overrides=[knob]))


@pytest.mark.parametrize("pe", [True, False], ids=["learnable_pe", "no_pe"])
def test_feature_head_validates(pe):
    """The feature head is ported, with and without the learnable PE map;
    without the head the base MLPs carry no semantic features."""
    on = ["nerf.model.head.enable_feature_head=true",
          f"nerf.model.head.enable_learnable_pe={str(pe).lower()}"]
    validate_cfg(flagship_config(tiny=True, overrides=on))
    _, _, model, _, _ = build_flagship(tiny=True, overrides=on, device="cpu")
    assert model.enable_feature_head and model.enable_learnable_pe == pe
    assert hasattr(model, "learnable_pe_map") == pe and hasattr(model, "pe_head") == pe
    assert model.base_mlp.layers[-1].out_features == 16 + 64
    _, _, plain, _, _ = build_flagship(tiny=True, device="cpu")
    assert plain.base_mlp.layers[-1].out_features == 16 and not hasattr(plain, "dino_head")


@pytest.mark.parametrize("profile", [REFERENCE_HASH, DYNAMIC, REFERENCE_BRICK],
                         ids=["reference_hash", "dynamic", "reference_brick"])
def test_reference_profiles_validate(profile):
    """The reference-hash, dynamic-only and reference-brick profiles and
    unfused brick grids are ported; with the hash grid, fine-level skipping
    raises the JAX package's ValueError."""
    validate_cfg(flagship_config(profile=profile))
    validate_cfg(flagship_config(tiny=True, profile=profile))
    if profile is REFERENCE_HASH:
        validate_cfg(flagship_config(tiny=True, overrides=["nerf.model.fuse_flow_grid=false"]))
        with pytest.raises(ValueError, match="requires grid_backend=brick"):
            validate_cfg(flagship_config(overrides=["nerf.propnet.fine_level_skip=1"],
                                         profile=REFERENCE_HASH))


# ---------------- spherical-harmonics directions ---------------- #

@pytest.fixture(scope="module")
def sh_pair():
    return _make_pair(overrides=["nerf.model.head.direction_encoding=sh"])


def test_sh_directions_radiance_field_matches_jax(sh_pair):
    """Degree-4 harmonics (16 lanes) feed the rgb head on (d + 1) / 2 and
    the sky head on the raw directions, as the reference does."""
    tmodel = sh_pair["tmodel"]
    app = tmodel.appearance_embedding_dim if tmodel.use_appearance_embedding else 0
    assert tmodel.direction_encoding == "sh"
    assert tmodel.sky_head.layers[0].in_features == 16 + app
    assert tmodel.rgb_head.layers[0].in_features == 16 + app + tmodel.geometry_feature_dim
    assert set(state_dict_from_jax(sh_pair["params"])) == set(tmodel.state_dict())
    ours, _ = _radiance_matches(sh_pair, 12, rtol=1e-5)
    assert "rgb_sky" in ours

