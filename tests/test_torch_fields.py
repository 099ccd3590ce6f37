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
    "nerf.model.perf.scatter_mode=flat",
    "nerf.model.perf.gather_mode=1d",
    "nerf.model.head.enable_dynamic_branch=false",  # the flow branch stays on
    "nerf.model.perf.reduce_mode=einsum",
])
def test_unported_knob_raises(knob):
    validate_cfg(flagship_config(tiny=True))  # the flagship itself is ported
    with pytest.raises(NotImplementedError):
        validate_cfg(flagship_config(tiny=True, overrides=[knob]))


def test_fused_lidar_branch_validates_and_builds():
    """``optim.fused_lidar_branch=true`` validates and builds on the full
    and the tiny flagship (the default staged lidar-K yields to it, as in
    the JAX package), and the step takes it."""
    from emernerf_torch.train.step import build_train_step

    on = ["optim.fused_lidar_branch=true"]
    validate_cfg(flagship_config(overrides=on))
    cfg, _, model, props, step_cfg = build_flagship(tiny=True, overrides=on, device="cpu")
    assert step_cfg.fused_branches and step_cfg.lidar_topk_until == 1.0
    assert build_train_step(model, props, step_cfg).cfg.fused_branches


@pytest.mark.parametrize("knob", ["nerf.model.grid_backend=mx",
                                  "nerf.propnet.fine_level_skip=2",
                                  "nerf.model.perf.grad_subsample=4",
                                  "optim.fused_lidar_branch=true"])
def test_the_four_settings_validate_on_the_full_flagship(knob):
    validate_cfg(flagship_config(overrides=[knob]))


def _density_fields(skip, spec=None):
    """A JAX and a port proposal field of one brick spec (the JAX package's
    test shape: 4 levels, F = 1, 4^3-cell bricks), the port's with the JAX
    field's initial params."""
    from emernerf_tpu.models.fields import DensityField as JaxDensityField
    from emernerf_tpu.ops.brickgrid import BrickGridSpec as JaxBrickSpec
    from emernerf_torch.models.fields import DensityField

    kw = dict(n_input_dims=3, n_levels=4, base_resolution=8, max_resolution=128,
              log2_bricks=8, n_features_per_level=1, log2_brick_size=2)
    spec = spec or BrickGridSpec(**kw)
    field_kw = dict(aabb=(-1, -1, -1, 1, 1, 1), unbounded=True, base_mlp_layer_width=16)
    jfield = JaxDensityField(spec=JaxBrickSpec(**kw), fine_level_skip=skip,
                             fine_level_frac=0.5, **field_kw)
    x = np.random.default_rng(5).normal(size=(5, 24, 3)).astype(np.float32) * 2.0
    params = jax.jit(jfield.init)(jax.random.PRNGKey(6), jnp.asarray(x))["params"]
    params = jax.tree.map(np.asarray, params)
    params["hash_table"] = np.random.default_rng(7).normal(
        size=params["hash_table"].shape).astype(np.float32)
    tfield = DensityField(spec, fine_level_skip=skip, fine_level_frac=0.5, **field_kw)
    tfield.load_state_dict(state_dict_from_jax(params), strict=True)
    return jfield, params, tfield, x


def test_density_field_fine_level_skip_matches_jax():
    """``fine_level_skip=2`` on JAX's near-segment test shape ((5, 24)
    samples: 8 near, 16 far): densities against JAX (rtol 1e-5, atol
    1e-6), the table gradient within 1e-5 x its largest |grad| (the sums of
    test_torch_brickgrid's VJPs, in another order); the near samples equal
    the unskipped field's bit for bit, the far ones differ."""
    jfield, params, tfield, x = _density_fields(2)
    cot = np.random.default_rng(8).normal(size=x.shape[:-1]).astype(np.float32)

    @jax.jit
    def density_vjp(p, c):
        out, vjp = jax.vjp(lambda q: jfield.apply({"params": q}, jnp.asarray(x)), p)
        return out, vjp(c)[0]["hash_table"]

    ref, ref_g = (np.asarray(v) for v in density_vjp(params, jnp.asarray(cot)))
    ours = tfield(torch.from_numpy(x))
    (g,) = torch.autograd.grad(ours, tfield.hash_table, torch.from_numpy(cot))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=0, atol=1e-5 * np.abs(ref_g).max())
    tfield.fine_level_skip = 0
    with torch.no_grad():
        full = tfield(torch.from_numpy(x))
    assert torch.equal(ours[:, :8].detach(), full[:, :8])
    assert not torch.equal(ours[:, 8:].detach(), full[:, 8:])
    flat = torch.from_numpy(x.reshape(-1, 3))
    tfield.fine_level_skip = 2  # flat point queries take the full encode
    with torch.no_grad():
        assert torch.equal(tfield(flat), full.reshape(-1))


def test_fine_level_skip_raises_the_jax_errors():
    """The JAX package's errors at the same points: the builders (a
    non-brick backend, k >= a proposal grid's levels) and the field (a
    skip that cannot engage at 8 proposal samples, a non-brick spec)."""
    from emernerf_torch.models.fields import DensityField

    with pytest.raises(ValueError, match="requires grid_backend=brick"):
        validate_cfg(flagship_config(overrides=["nerf.propnet.fine_level_skip=1",
                                                "nerf.model.grid_backend=mx"]))
    with pytest.raises(ValueError, match="must be < the prop grid's n_levels"):
        validate_cfg(flagship_config(tiny=True, overrides=["nerf.propnet.fine_level_skip=2"]))
    _, _, _, props, _ = build_flagship(tiny=True, overrides=["nerf.propnet.fine_level_skip=1"],
                                       device="cpu")
    with pytest.raises(ValueError, match="cannot engage: sample count 8"):
        props[0](torch.zeros(4, 8, 3))
    hashed = DensityField(HashGridSpec(n_levels=2, log2_hashmap_size=8), fine_level_skip=1)
    with pytest.raises(ValueError, match="requires a 3D brick-grid spec"):
        hashed(torch.zeros(2, 24, 3))


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



@pytest.mark.parametrize("expanded", [False, True])
def test_embedding_lookup_is_the_embedding_with_its_gradient(monkeypatch, expanded):
    """``embedding_lookup`` returns nn.Embedding's rows and, through its
    float64 one-hot products (blocks of 64 rows here: 130 rows), the same
    table gradient up to the order of the sums; an index expanded over its
    last dimension (the renderer's per-sample view of each ray's index) is
    looked up once per ray and gives the same rows and gradient."""
    from emernerf_torch.models import fields

    g = torch.Generator().manual_seed(3)
    weight = torch.randn((130, 16), generator=g, requires_grad=True)
    idx = torch.randint(0, 130, (50, 1 if expanded else 7), generator=g)
    idx[:3, 0] = torch.tensor([0, 64, 129])
    idx = idx.int().expand(50, 7)
    monkeypatch.setattr(fields, "_EMBED_ONE_HOT_ENTRIES", 64 * (50 if expanded else 350))
    cot = torch.randn((50, 7, 16), generator=g)
    assert (idx.stride(1) == 0) == expanded
    out = fields.embedding_lookup(weight, idx)
    ref = torch.nn.functional.embedding(idx.long(), weight)
    assert torch.equal(out, ref)
    (ours,) = torch.autograd.grad(out, weight, cot)
    (theirs,) = torch.autograd.grad(ref, weight, cot)
    torch.testing.assert_close(ours, theirs, rtol=1e-6, atol=1e-6)


def _reaches(fn, name):
    return fn is not None and (type(fn).__name__ == name or
                               any(_reaches(f, name) for f, _ in fn.next_functions))


def test_appearance_embedding_takes_the_deterministic_lookup():
    """The field's appearance rows come through ``embedding_lookup``, whose
    gradient the card reproduces bit for bit (``nn.Embedding``'s does not:
    ``emernerf_torch/perf/bench_embedding.py``), for a per-sample index and
    for the renderer's expanded per-ray one."""
    from emernerf_torch.flagship import build_flagship

    _, _, model, _, _ = build_flagship(tiny=True, device="cpu")
    assert model.use_appearance_embedding
    for idx in (torch.tensor([[0, 1], [2, 0]]), torch.tensor([2, 0])[:, None].expand(2, 3)):
        out = model._appearance(tuple(idx.shape), {"img_idx": idx, "cam_idx": idx})
        assert _reaches(out.grad_fn, "_EmbeddingLookupBackward")
        assert torch.equal(out, model.appearance_embedding.weight[idx])
