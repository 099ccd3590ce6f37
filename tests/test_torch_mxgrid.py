"""Port parity: the MX grid (``emernerf_torch/ops/mxgrid.py``: K1 on the
brick prefix, the plain versions of K12 on the lines) against
``emernerf_tpu/ops/mxgrid.py``'s ``mxgrid_encode`` (the tent matmuls) and
its autodiff, on the CPU; the tiny MX flagship's fields and one training
iteration against the JAX package's.

Tolerances:
- fp32 forward: 4 ulps of the largest |output| (measured 2: the tents' dot
  products and the port's gathered pairs round their sums differently);
- fp32 VJPs: lines 1e-5 x the largest |grad| (sums over the points in
  another order; measured 5.3e-6), positions 1e-6 x the largest |grad|
  (measured 1.6e-7), at random points and at knots, where both take
  autodiff's derivative of the tents;
- bf16 lines: the line outputs exactly (both round the weights and values
  to bf16 and form exact products), the brick prefix within K1's bf16
  bound of test_torch_brickgrid; table gradients within 2 bf16 ulps of
  the largest |grad| (JAX rounds each 256-point chunk's line cotangent to
  bf16 and adds the chunks in bf16, so an element's error follows the size
  of its partial sums, not its own; the port sums in fp32 and rounds once;
  measured 1 ulp), positions 2^-5 x the largest |grad| (JAX rounds each
  tent's cotangent to bf16; measured 2.3e-3);
- the fields and the training iteration as ``test_torch_fields`` and
  ``test_torch_train_step``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emernerf_tpu import builders as jax_builders
from emernerf_tpu.ops.mxgrid import MXGridSpec as JaxSpec
from emernerf_tpu.ops.mxgrid import mxgrid_encode as jax_encode
from emernerf_tpu.parallel.spmd import _is_big as jax_is_big
from emernerf_tpu.train.step import init_train_state as jax_init_train_state
from emernerf_torch import builders
from emernerf_torch.convert import load_jax_params, load_jax_train_state, state_dict_from_jax
from emernerf_torch.flagship import DEFAULT_PROFILE, build_flagship, flagship_config
from emernerf_torch.ops.mxgrid import (
    MXGridSpec,
    _kernel_params,
    check_spec,
    init_mxgrid_table,
    mx_lines_encode,
    mx_lines_encode_bwd_ref,
    mx_lines_encode_ref,
    mxgrid_encode,
    plan_slots,
)
from emernerf_torch.parallel import spmd as tspmd
from test_torch_brickgrid import bf16_ulp
from test_torch_fields import _inputs, jax_build_profile
from test_torch_train_step import (  # noqa: F401  (taps: a fixture)
    FP32,
    WIDE,
    Pair,
    _assert_grads_close,
    _assert_losses_close,
    _jax_side,
    _named,
    taps,
)

MX = ["nerf.model.grid_backend=mx"]
# the lines start at N(0, 0.2^2), the brick prefix at U(+-1e-4): scaled so
# that both drive the outputs, and products of 3-4 lines stay O(1)
LINE_SCALE, BRICK_SCALE = 3.0, 2000.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec3(**kw):
    base = dict(n_input_dims=3, n_levels=6, base_resolution=8, max_resolution=128,
                n_features_per_level=4, rank=4, chunk=256)
    return {**base, **kw}


def _spec4(**kw):
    base = dict(n_input_dims=4, n_levels=5, base_resolution=8, max_resolution=64,
                n_features_per_level=8, rank=4, time_resolution=12, chunk=256)
    return {**base, **kw}


SPECS = {"3d": _spec3, "4d": _spec4}


def _assert_same_geometry(ours: MXGridSpec, ref: JaxSpec):
    assert ours.part_sizes == ref._part_sizes and ours.table_shape == ref.table_shape
    assert ours.n_brick_levels == ref.n_brick_levels and ours.n_scales == ref.n_scales
    np.testing.assert_array_equal(ours.level_resolutions, ref.level_resolutions)
    np.testing.assert_array_equal(ours.factored_resolutions, ref.factored_resolutions)
    for a in range(ref.axes_per_scale):
        np.testing.assert_array_equal(ours.axis_freqs(a), ref.axis_freqs(a))
    if ref.brick_spec is not None:
        assert ours.brick_spec.table_shape == ref.brick_spec.table_shape
        np.testing.assert_array_equal(np.float32(ours.brick_spec.level_scales),
                                      np.float32(ref.brick_spec.level_scales))
        assert not ours.brick_spec.level_uses_hash.any()


def _flagship_mx_specs(jax_side: bool, tiny: bool):
    cfg = flagship_config(tiny=tiny, overrides=MX)
    m, enc = cfg.nerf.model, cfg.nerf.propnet.xyz_encoder

    def make(**kw):
        if jax_side:
            return jax_builders.make_grid_spec("mx", perf=jax_builders._perf_cfg(cfg), **kw)
        return builders.make_grid_spec("mx", perf=builders.cfg_perf(cfg), **kw)

    def from_enc(e):
        return make(n_input_dims=e.n_input_dims, n_levels=e.n_levels,
                    base_resolution=e.base_resolution, max_resolution=e.max_resolution,
                    log2_hashmap_size=e.log2_hashmap_size,
                    n_features_per_level=e.n_features_per_level)

    flow = (make(n_input_dims=4, n_levels=4, base_resolution=8, max_resolution=64,
                 log2_hashmap_size=10, n_features_per_level=2) if tiny else
            make(n_input_dims=4, n_levels=10, base_resolution=16, max_resolution=4096,
                 log2_hashmap_size=18, n_features_per_level=4))
    dyn = from_enc(m.dynamic_xyz_encoder)
    specs = {"static": from_enc(m.xyz_encoder), "dynflow": dataclasses.replace(
        dyn, n_features_per_level=dyn.n_features_per_level + flow.n_features_per_level)}
    for i in range(2):
        specs[f"prop{i}"] = make(
            n_input_dims=enc.n_input_dims, n_levels=enc.n_levels_per_prop[i],
            base_resolution=enc.base_resolutions_per_prop[i],
            max_resolution=enc.max_resolution_per_prop[i],
            log2_hashmap_size=enc.lgo2_hashmap_size_per_prop[i],
            n_features_per_level=enc.n_features_per_level)
    return specs


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
def test_flagship_spec_geometry_matches_jax(tiny):
    """Every grid of the MX flagship, tiny and at full width: part sizes,
    padding, the brick prefix and the lines' resolutions and periods (no
    table is built).  At full width: the fused grid 10 scales of W = 128
    with no brick prefix, the static grid 8 scales of W = 64, the proposal
    grids 5 scales of W = 16."""
    ours, ref = _flagship_mx_specs(False, tiny), _flagship_mx_specs(True, tiny)
    for name in ours:
        _assert_same_geometry(ours[name], ref[name])
    if not tiny:
        shape = {k: (s.n_input_dims, s.n_scales, s.factor_width) for k, s in ours.items()}
        assert shape == {"static": (3, 8, 64), "dynflow": (4, 10, 128),
                         "prop0": (3, 5, 16), "prop1": (3, 5, 16)}
        assert ours["dynflow"].table_shape == (1_310_720,)


# an H100 block's shared memory (227 KB)
H100_BLOCK_SHARED = 232_448
_DTYPE_PAIRS = [(a, b) for a in (torch.float32, torch.bfloat16)
                for b in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
def test_slot_plan_fits_every_flagship_spec(tiny):
    """K12's value slots (``plan_slots``) for every MX flagship grid and
    every stored / compute pair: powers of two at most the spec's lanes,
    the forward's at least F, each block within an H100 block's shared
    memory.  At full width the fused grid's fp32 backward takes 16-lane
    slots (a slice and its partials of 32 lanes, 256 KB, do not fit) and
    every other block 32 lanes (16 at the proposal grids' W = 16)."""
    specs = _flagship_mx_specs(False, tiny)
    for name, spec in specs.items():
        check_spec(spec)
        for stored, compute in _DTYPE_PAIRS:
            plan = plan_slots(spec, stored, compute)
            for lanes in (plan.lanes, plan.bwd_lanes):
                assert lanes & (lanes - 1) == 0 and lanes <= spec.lanes, (name, plan)
            assert plan.lanes >= spec.n_features_per_level, (name, plan)
            assert max(plan.shared, plan.bwd_shared) <= H100_BLOCK_SHARED, (name, plan)
            p = _kernel_params(spec, stored, compute)
            assert (p.lanes, p.bwd_lanes) == (plan.lanes, plan.bwd_lanes)
            assert p.values * p.lanes >= spec.factor_width > (p.values - 1) * p.lanes
            assert p.bwd_values * p.bwd_lanes >= spec.factor_width
    if not tiny:
        got = {(k, str(a)[6:], str(b)[6:]): (plan.lanes, plan.bwd_lanes)
               for k, spec in specs.items() for a, b in _DTYPE_PAIRS
               for plan in [plan_slots(spec, a, b)]}
        fp32_fused = ("dynflow", "float32", "float32")
        assert got[fp32_fused] == (32, 16)
        assert all(v == (32, 32) for key, v in got.items()
                   if key[0] in ("static", "dynflow") and key != fp32_fused)
        assert all(v == (16, 16) for (k, _, _), v in got.items() if k.startswith("prop"))


def test_oversized_line_block_raises():
    """A spec whose slot fits no block's shared memory at any width raises,
    in ``check_spec`` and in both wrappers (also on the CPU); the largest
    line_block that fits passes."""
    kw = _spec4()
    big = MXGridSpec(**{**kw, "line_block": 4096})
    with pytest.raises(ValueError, match="shared memory"):
        check_spec(big)
    with pytest.raises(ValueError, match="shared memory"):
        plan_slots(big, torch.bfloat16, torch.bfloat16)
    lines = torch.zeros(sum(big.part_sizes[1:]))
    x = torch.rand((4, 4))
    with pytest.raises(ValueError, match="shared memory"):
        mx_lines_encode(lines, x, big)
    check_spec(MXGridSpec(**{**kw, "line_block": 256}))


def test_bench_compare_holds_outputs_to_their_tolerances():
    """``perf/bench_mxgrid.py --compare``: the forward's checksum exactly,
    the line gradient within rtol 1e-5 (fp32) or 2^-7 (bf16) + 1e-5 x its
    largest |grad|, the position gradient within 1e-5 x its largest |grad|;
    every fault named."""
    from emernerf_torch.perf.bench_mxgrid import checksum, compare

    g = torch.Generator().manual_seed(5)
    out, d_l, d_x = (torch.randn((64, 8), generator=g) for _ in range(3))

    def row(o, dl, dx):
        return dict(out=checksum(o), d_lines=dl, d_pos=dx)

    for tag, rtol in (("[fused,N=64,fp32]", 1e-5), ("[fused,N=64,fp32->bf16]", 2 ** -7)):
        saved = {tag: row(out, d_l, d_x)}
        assert compare(saved, {tag: row(out.clone(), d_l * (1 + rtol / 2), d_x)}) == []
        assert compare(saved, {tag: row(out, d_l, None)}) != []
        faults = compare(saved, {tag: row(out + 1e-7, d_l * (1 + 4 * rtol),
                                          d_x + 1e-4 * float(d_x.abs().max()))})
        assert [f.split(":")[0] for f in faults] == [tag, f"{tag}.d_lines", f"{tag}.d_pos"]
    assert compare({"[a,fp32]": row(out, d_l, None)}, {"[a,fp32]": row(out, d_l, None)}) == []


def _encode_pair(spec_kw, x, cot, compute_dtype, seed=0):
    """(port encode, table grad, position grad), (JAX ...) on one table."""
    tspec, jspec = MXGridSpec(**spec_kw), JaxSpec(**spec_kw)
    _assert_same_geometry(tspec, jspec)
    table = init_mxgrid_table(tspec, generator=torch.Generator().manual_seed(seed))
    table = (table * LINE_SCALE).numpy()
    jdt = jnp.bfloat16 if compute_dtype == torch.bfloat16 else jnp.float32

    @jax.jit
    def encode_vjp(t, p, c):
        out, vjp = jax.vjp(lambda t, p: jax_encode(t.astype(jdt), p, jspec), t, p)
        return (out, *vjp(c))

    ref, ref_t, ref_x = (np.asarray(v) for v in encode_vjp(
        jnp.asarray(table), jnp.asarray(x), jnp.asarray(cot)))
    tt = torch.from_numpy(table).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = mxgrid_encode(tt, tx, tspec, compute_dtype)
    d_t, d_x = torch.autograd.grad(out, [tt, tx], torch.from_numpy(cot))
    return tspec, (out.detach().numpy(), d_t.numpy(), d_x.numpy()), \
        (np.asarray(ref, np.float32), ref_t, ref_x)


def _fp32_close(ours, ref):
    out, d_t, d_x = ours
    r_out, r_t, r_x = ref
    assert out.dtype == np.float32 and out.shape == r_out.shape
    np.testing.assert_allclose(out, r_out, rtol=0, atol=4 * np.spacing(np.abs(r_out).max()))
    np.testing.assert_allclose(d_t, r_t, rtol=0, atol=1e-5 * np.abs(r_t).max())
    np.testing.assert_allclose(d_x, r_x, rtol=0, atol=1e-6 * np.abs(r_x).max())
    assert np.abs(r_x).max() > 1.0  # the position gradient is exercised


def _knot_points(n_in: int) -> np.ndarray:
    """Coordinates at knots of the coarse line (0, 1) and of the periodic
    lines (k / 128 periods apart, 1/2, 1/4), at 1 - eps and eps (the
    periodic wrap), and just past a knot, in every combination of two."""
    vals = np.array([0.0, 1.0, 0.5, 0.25, 0.75, 1 / 8, 3 / 8, 1 - 2 ** -24, 2 ** -24,
                     0.5 + 2 ** -24, 7 / 128, 1 - 1 / 128], np.float32)
    grid = np.stack(np.meshgrid(vals, vals, indexing="ij"), -1).reshape(-1, 2)
    cols = [grid[:, 0], grid[:, 1], grid[:, 0][::-1], grid[:, 1][::-1]]
    return np.stack(cols[:n_in], -1).astype(np.float32)


@pytest.mark.parametrize("dims", sorted(SPECS))
def test_encode_and_vjp_match_jax(dims):
    """1,000 random points (chunks of 256 and a partial one), then points
    at knots and at the periodic wrap, fp32.  At a knot the position
    gradient is autodiff's of the tents (three rows: max's tie at 0 counts
    0.5, |0|'s slope is +1), not the lerp's slope; the port matches JAX
    there too."""
    rng = np.random.default_rng(10 + len(dims))
    spec_kw = SPECS[dims]()
    n_in = spec_kw["n_input_dims"]
    x = np.concatenate([rng.uniform(0.0, 1.0, (1000, n_in)).astype(np.float32),
                        _knot_points(n_in)])
    cot = rng.normal(size=(x.shape[0], spec_kw["n_levels"] * spec_kw["n_features_per_level"]))
    tspec, ours, ref = _encode_pair(spec_kw, x, cot.astype(np.float32), torch.float32)
    assert tspec.n_brick_levels > 0 and tspec.n_scales > 1
    _fp32_close(ours, ref)


def test_knot_gradient_is_the_tents_not_the_lerps():
    """One coarse line of block 8 holding 1..8 (the other axes' coarse
    lines 1, every periodic line 0, rank 1, F = 1): d out / d x0 is 0 at
    c = 0, -80.5 at c = 1 and -21 at c = 3/7 (the lerp's slope is 7
    everywhere), as JAX's autodiff gives it."""
    kw = dict(n_input_dims=3, n_levels=2, base_resolution=8, max_resolution=16,
              n_features_per_level=1, rank=1, line_block=8)
    spec = MXGridSpec(**kw)
    assert spec.n_scales >= 1
    part, blk, ns = spec.axis_part, spec.line_block, spec.n_scales
    lines = torch.zeros(3 * part)
    for a in range(3):
        coarse = lines[a * part:a * part + ns * blk].view(ns, blk)
        coarse[:] = torch.arange(1.0, 9.0) if a == 0 else 1.0
    c = torch.tensor([0.0, 1.0, 3 / 7])
    pos = torch.stack([c, torch.full_like(c, 0.3), torch.full_like(c, 0.6)], -1)
    g = torch.zeros(3, ns)
    g[:, 0] = 1.0
    _, d_pos = mx_lines_encode_bwd_ref(lines, pos, g, spec, True)
    np.testing.assert_allclose(d_pos[:, 0].numpy(), [0.0, -80.5, -21.0], rtol=1e-6)
    jspec = JaxSpec(**kw)
    table = np.concatenate([np.zeros(spec.part_sizes[0], np.float32), lines.numpy()])
    table = np.pad(table, (0, spec.table_shape[0] - table.size))
    cot = np.zeros((3, spec.n_output_dims), np.float32)
    cot[:, spec.n_brick_levels] = 1.0
    grad = jax.jit(lambda p: jax.vjp(lambda q: jax_encode(jnp.asarray(table), q, jspec), p)[1](
        jnp.asarray(cot))[0])
    np.testing.assert_allclose(np.asarray(grad(jnp.asarray(pos.numpy())))[:, 0],
                               [0.0, -80.5, -21.0], rtol=1e-6)


@pytest.mark.parametrize("dims", sorted(SPECS))
def test_bf16_computation_within_rounding_of_jax(dims):
    """The fp32 table with a bf16 computation against JAX's encode of
    ``table.astype(bf16)``: the lines' features exactly, the brick prefix
    within K1's bound, gradients within the module docstring's bounds."""
    rng = np.random.default_rng(30 + len(dims))
    spec_kw = SPECS[dims]()
    x = rng.uniform(0.0, 1.0, (1000, spec_kw["n_input_dims"])).astype(np.float32)
    cot = rng.normal(size=(1000, spec_kw["n_levels"] * spec_kw["n_features_per_level"]))
    tspec, (out, d_t, d_x), (r_out, r_t, r_x) = _encode_pair(
        spec_kw, x, cot.astype(np.float32), torch.bfloat16, seed=2)
    nb = tspec.n_brick_levels * tspec.n_features_per_level
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out[:, nb:], r_out[:, nb:])
    assert np.abs(out[:, :nb] - r_out[:, :nb]).max() <= 8 * bf16_ulp(np.abs(r_out[:, :nb])).max()
    assert np.array_equal(d_t, d_t.astype(jnp.bfloat16).astype(np.float32))  # rounded once
    assert np.abs(d_t - r_t).max() <= 2 * bf16_ulp(np.abs(r_t).max())
    np.testing.assert_allclose(d_x, r_x, rtol=0, atol=2 ** -5 * np.abs(r_x).max())


def test_plain_versions_chunk_and_wrapper_checks():
    """The plain versions give the same result whatever the chunk; the
    wrapper takes the plain version on the CPU and refuses a wrong
    line length; the kernel parameters carry the lanes' layout."""
    kw = _spec4()
    spec, small = MXGridSpec(**kw), MXGridSpec(**{**kw, "chunk": 7})
    g = torch.Generator().manual_seed(4)
    lines = init_mxgrid_table(spec, generator=g)[spec.part_sizes[0]:spec.num_parameters] * 3
    x = torch.rand((100, 4), generator=g)
    cot = torch.randn((100, spec.n_scales * spec.n_features_per_level), generator=g)
    assert torch.equal(mx_lines_encode_ref(lines, x, spec), mx_lines_encode_ref(lines, x, small))
    for a, b in zip(mx_lines_encode_bwd_ref(lines, x, cot, spec, True),
                    mx_lines_encode_bwd_ref(lines, x, cot, small, True)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(a.abs().max()))
    before = mx_lines_encode.launches
    assert torch.equal(mx_lines_encode(lines, x, spec), mx_lines_encode_ref(lines, x, spec))
    assert mx_lines_encode.launches == before
    with pytest.raises(ValueError):
        mx_lines_encode(lines[:-1], x, spec)
    p = _kernel_params(spec)
    assert (p.lanes, p.values, p.width) == (32, 1, 32) and p.axis_part == spec.axis_part


# ---------------------------------------------------------------- the tiny MX flagship


def _scale(tree):
    """Brick tables x BRICK_SCALE; an MX table (1D) x LINE_SCALE."""
    def one(k, v):
        v = np.asarray(v)
        if not k.endswith("table"):
            return v
        return v * (LINE_SCALE if v.ndim == 1 else BRICK_SCALE)

    return {k: (_scale(v) if isinstance(v, dict) else one(k, v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def mx_pair():
    overrides = ["nerf.model.table_dtype=float32", "nerf.model.mlp_dtype=float32"] + MX
    cfg, dataset, jmodel, jprops, step_cfg = jax_build_profile(DEFAULT_PROFILE, overrides)
    r = cfg.data.ray_batch_size
    batch = {"origins": jnp.zeros((r, 3)), "normed_timestamps": jnp.zeros((r,)),
             "img_idx": jnp.zeros((r,), jnp.int32), "cam_idx": jnp.zeros((r,), jnp.int32),
             "pixel_coords": jnp.zeros((r, 2))}
    state = jax.jit(lambda key: jax_init_train_state(jmodel, jprops, step_cfg, key, batch))(
        jax.random.PRNGKey(0))
    params = _scale(jax.tree.map(np.asarray, state.params))
    prop_params = tuple(_scale(jax.tree.map(np.asarray, p)) for p in state.prop_params)
    tcfg, _, tmodel, tprops, _ = build_flagship(tiny=True, overrides=overrides, device="cpu")
    assert tcfg.to_dict() == cfg.to_dict()
    load_jax_params(tmodel, tprops, params, prop_params)
    return dict(dataset=dataset, jmodel=jmodel, jprops=jprops, params=params,
                prop_params=prop_params, tmodel=tmodel, tprops=tprops)


def test_mx_flagship_fields_match_jax(mx_pair):
    """The tiny MX flagship (fused dynamic+flow MX grid of F = 6, top-2
    temporal aggregation): every output of the radiance field and both
    proposal densities against JAX, rtol 1e-4, atol 1e-5."""
    tmodel = mx_pair["tmodel"]
    assert tmodel.fused and isinstance(tmodel.dynflow_spec, MXGridSpec)
    assert tmodel.dynflow_spec.n_features_per_level == 6
    assert set(state_dict_from_jax(mx_pair["params"])) == set(tmodel.state_dict())
    pos, dirs, data = _inputs(mx_pair["dataset"], seed=40)
    ref = jax.jit(lambda prm, x, d, dd: mx_pair["jmodel"].apply(
        {"params": prm}, x, d, dd, train=False))(mx_pair["params"], pos, dirs, data)
    with torch.no_grad():
        ours = tmodel(torch.from_numpy(pos), torch.from_numpy(dirs),
                      {k: torch.from_numpy(v) for k, v in data.items()})
    assert set(ours) == set(ref) and "agg_mask" in ours
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for level, (jprop, tprop) in enumerate(zip(mx_pair["jprops"], mx_pair["tprops"])):
        ref = jax.jit(jprop.apply)({"params": mx_pair["prop_params"][level]}, pos)
        with torch.no_grad():
            np.testing.assert_allclose(tprop(torch.from_numpy(pos)).numpy(), np.asarray(ref),
                                       rtol=1e-4, atol=1e-5)


def test_mx_routing_matches_jax(mx_pair):
    """ZeRO routes the padded 1D MX tables by their length, as the JAX
    package routes the leaf (2 and 4 ranks, a small threshold)."""
    tmodel = mx_pair["tmodel"]
    names = [n for n, _ in tmodel.named_parameters()]
    leaves = state_dict_from_jax(mx_pair["params"])
    for n_ranks in (2, 4):
        cfg = tspmd.SpmdConfig(zero=True, zero_min_elems=4096)
        route = tspmd.routing(list(tmodel.parameters()), tspmd.transposed_params(tmodel), cfg,
                              n_ranks)
        for name, big, flip in zip(names, route.big, route.transposed):
            leaf = leaves[name].numpy()
            assert big == jax_is_big(leaf.T if flip else leaf, n_ranks, 4096), name
        assert all(big for name, big in zip(names, route.big) if name.endswith("table"))


@pytest.fixture(scope="module")
def mx_jax_side(taps):
    js = _jax_side(taps, DEFAULT_PROFILE, FP32 + WIDE + MX)
    js["params"] = _scale(jax.tree.map(np.asarray, js["state"].params))
    js["prop_params"] = tuple(_scale(jax.tree.map(np.asarray, p))
                              for p in js["state"].prop_params)
    return js


def test_mx_flagship_iteration_matches_jax(mx_jax_side, monkeypatch):
    """One iteration of the tiny MX flagship, both branches with proposal
    gradients: every loss and every gradient handed to Adam (the fused
    grid's warped queries take K12's position gradient), tolerances as
    test_torch_train_step.  Then JAX's state after it (the flat MX tables
    and their Adam moments) carries into the port exactly."""
    pair = Pair(mx_jax_side)
    assert isinstance(pair.tstate.model.dynflow_spec, MXGridSpec)
    pb, lb = pair.batches(0)
    jm, tm, jgrads, tgrads = pair.run(pb, lb, True, True, seed=7, monkeypatch=monkeypatch)
    _assert_losses_close(tm, jm)
    assert jm["prop_loss"] > 0 and jm["cycle_loss"] > 0
    order = ["prop", "model", "prop", "model"]
    assert len(jgrads) == len(tgrads) == len(order)
    for kind, jg, tg in zip(order, jgrads, tgrads):
        _assert_grads_close(_named(jg, kind == "prop"), tg,
                            pair.prop_names if kind == "prop" else pair.names)
    after = jax.tree.map(np.asarray, pair.jstate)
    adam, prop_adam = after.opt_state[1], after.prop_opt_state[1]
    fresh = Pair(mx_jax_side)
    state = load_jax_train_state(fresh.tstate, after.params, after.prop_params,
                                 (adam.count, adam.mu, adam.nu),
                                 (prop_adam.count, prop_adam.mu, prop_adam.nu), after.step)
    assert state.step == 1 and state.opt_state.count == 2
    for ours, theirs, names, prop in ((state.opt_state, adam, fresh.names, False),
                                      (state.prop_opt_state, prop_adam, fresh.prop_names, True)):
        for mine, tree in ((ours.mu, theirs.mu), (ours.nu, theirs.nu)):
            ref = _named(tree, prop)
            for name, m in zip(names, mine):
                assert torch.equal(m.float(), ref[name]), name
    assert state.model.xyz_table.dim() == 1
    assert torch.equal(state.model.xyz_table.detach(), _named(after.params, False)["xyz_table"])
