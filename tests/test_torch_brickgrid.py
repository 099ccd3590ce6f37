"""Port parity: emernerf_torch brick-grid encoder (plain versions of kernel
K1, forward and backward) against emernerf_tpu's ``brickgrid_encode_ref``
and the VJP of its custom-VJP ``brickgrid_encode``, on the CPU in fp32.

Points sit on, just below and just above cell and brick boundaries, where a
differently rounded ``x * scale + 0.5`` would pick another cell (and, across
a brick boundary, another table row).  Tolerance: atol 1e-6 on outputs of
O(1) table values (sums of 8-16 fp32 products, different order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emernerf_tpu import builders as jax_builders
from emernerf_tpu.ops.brickgrid import BrickGridSpec as JaxSpec
from emernerf_tpu.ops.brickgrid import brickgrid_encode as jax_encode
from emernerf_tpu.ops.brickgrid import _level_constants as jax_level_constants
from emernerf_tpu.ops.brickgrid import brickgrid_encode_ref as jax_encode_ref
from emernerf_tpu.ops.grid import grid_encode as jax_grid_encode
from emernerf_torch import builders, kernels
from emernerf_torch.flagship import REFERENCE_BRICK, build_flagship, flagship_config
from emernerf_torch.ops.grid import grid_encode
from emernerf_torch.ops.brickgrid import (
    BrickGridSpec,
    _kernel_params,
    brickgrid_encode,
    brickgrid_encode_bwd_ref,
    brickgrid_encode_ref,
    effective_subsample,
    level_constants,
    subsample_rows,
)

# (n_input_dims, F, log2_brick_size, time_pair); log2_bricks picked so the
# coarse levels are dense (linear rows) and the fine ones hashed
VARIANTS = {
    "3d_b2cells_F4": (3, 4, 1, False),
    "3d_b4cells_F1": (3, 1, 2, False),
    "4d_pair_F8": (4, 8, 1, True),
    "4d_unpaired_F2": (4, 2, 1, False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(variant, log2_cells):
    """Table sized by its cell capacity, as the builders size it."""
    d, f, bs, pair = VARIANTS[variant]
    return dict(n_input_dims=d, n_levels=4, base_resolution=4, max_resolution=64,
                log2_bricks=log2_cells - 3 * bs, n_features_per_level=f,
                log2_brick_size=bs, time_pair=pair)


def _boundary_points(spec, rng, n_random=256):
    """Random points plus points at cell / brick boundaries of every level,
    nudged by -1, 0, +1 ulp (float32)."""
    d = spec.n_input_dims
    pts = [rng.uniform(0.0, 1.0, (n_random, d)).astype(np.float32)]
    scales = np.asarray(spec.level_scales, np.float32)
    for sc in scales:
        # boundary of cell c: x * sc + 0.5 == c  ->  x = (c - 0.5) / sc
        cells = rng.integers(1, int(sc) + 1, size=(64, d))
        cells[:32] = (cells[:32] // (2 * spec.brick_cells)) * 2 * spec.brick_cells + spec.brick_cells
        x = ((cells - 0.5) / sc).astype(np.float32)
        for nudge in (-1, 0, 1):
            xn = x.copy()
            if nudge:
                xn = np.nextafter(xn, np.float32(nudge * np.inf)).astype(np.float32)
            pts.append(np.clip(xn, 0.0, 1.0))
    return np.concatenate(pts).astype(np.float32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("log2_cells", [9, 15], ids=["small_table", "large_table"])
def test_encode_ref_matches_jax(variant, log2_cells):
    kw = _spec(variant, log2_cells)
    tspec, jspec = BrickGridSpec(**kw), JaxSpec(**kw)
    rng = np.random.default_rng(100 * sorted(VARIANTS).index(variant) + log2_cells)
    # both row kinds: dense (linear) coarse levels, hashed fine levels
    assert tspec.level_uses_hash.any() and not tspec.level_uses_hash.all()
    table = rng.uniform(-1.0, 1.0, tspec.table_shape).astype(np.float32)
    pos = _boundary_points(tspec, rng).reshape(-1, 8, kw["n_input_dims"])
    ours = brickgrid_encode(torch.from_numpy(table), torch.from_numpy(pos), tspec)
    ref = np.asarray(jax_encode_ref(jnp.asarray(table), jnp.asarray(pos), jspec))
    assert ours.shape == ref.shape == (*pos.shape[:-1], tspec.n_output_dims)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)


def _bwd_inputs(variant, seed):
    kw = _spec(variant, 15)
    tspec, jspec = BrickGridSpec(**kw), JaxSpec(**kw)
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.0, 1.0, tspec.table_shape).astype(np.float32)
    pos = _boundary_points(tspec, rng)
    cot = rng.normal(size=(pos.shape[0], tspec.n_output_dims)).astype(np.float32)
    return tspec, jspec, table, pos, cot


def _bwd_ref(tspec, table, pos, cot, needs_pos_grad=True):
    return brickgrid_encode_bwd_ref(torch.from_numpy(table), torch.from_numpy(pos),
                                    torch.from_numpy(cot), tspec, needs_pos_grad)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bwd_ref_matches_jax_vjp(variant):
    """The explicit plain backward (the kernel's order of operations)
    against jax.vjp of the custom-VJP encode with position gradients, on
    points at +-1 ulp of cell and brick boundaries.  Tolerance, x the
    largest |grad|: table 1e-5 (JAX scatters its dense weight-row updates
    in another order; measured 3.8e-6), positions 1e-6 (JAX reads
    forward-saved reductions, the port re-reads the corners; measured
    2.0e-7)."""
    tspec, jspec, table, pos, cot = _bwd_inputs(variant, 30 + sorted(VARIANTS).index(variant))
    d_t, d_x = _bwd_ref(tspec, table, pos, cot)
    _, vjp = jax.vjp(lambda t, x: jax_encode(t, x, jspec, True), jnp.asarray(table),
                     jnp.asarray(pos))
    ref_t, ref_x = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    assert d_t.dtype == torch.float32 and d_t.shape == ref_t.shape
    assert d_x.shape == ref_x.shape == pos.shape
    np.testing.assert_allclose(d_t.numpy(), ref_t, rtol=0, atol=1e-5 * np.abs(ref_t).max())
    np.testing.assert_allclose(d_x.numpy(), ref_x, rtol=0, atol=1e-6 * np.abs(ref_x).max())
    assert np.abs(ref_x).max() > 1.0  # the position gradient is exercised


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bwd_ref_matches_autograd_of_the_forward(variant):
    """The explicit plain backward against autograd of the plain forward
    (the earlier oracle), which rounds the time lerp and the weights in
    another order: atol 1e-6 x the largest |grad| (measured 2.2e-7).
    Without position gradients the table gradient is the same tensor."""
    tspec, _, table, pos, cot = _bwd_inputs(variant, 40 + sorted(VARIANTS).index(variant))
    d_t, d_x = _bwd_ref(tspec, table, pos, cot)
    t = torch.from_numpy(table).requires_grad_(True)
    x = torch.from_numpy(pos).requires_grad_(True)
    want_t, want_x = torch.autograd.grad(brickgrid_encode_ref(t, x, tspec), [t, x],
                                         torch.from_numpy(cot))
    for ours, want in ((d_t, want_t), (d_x, want_x)):
        torch.testing.assert_close(ours, want, rtol=0, atol=1e-6 * float(want.abs().max()))
    t_only, none = _bwd_ref(tspec, table, pos, cot, needs_pos_grad=False)
    assert none is None and torch.equal(t_only, d_t)


def test_bwd_ref_bf16_table_casts_once():
    """A bf16 table: the cotangent in the table's dtype, fp32 sums, the
    table gradient cast once (as the kernel's wrapper casts its buffer)."""
    tspec, _, table, pos, cot = _bwd_inputs("4d_pair_F8", 5)
    t16 = torch.from_numpy(table).bfloat16()
    c16 = torch.from_numpy(cot).bfloat16()
    d_t, d_x = brickgrid_encode_bwd_ref(t16, torch.from_numpy(pos), c16, tspec, True)
    w_t, w_x = brickgrid_encode_bwd_ref(t16.float(), torch.from_numpy(pos), c16.float(), tspec,
                                        True)
    assert d_t.dtype == torch.bfloat16 and d_x.dtype == torch.float32
    assert torch.equal(d_t, w_t.bfloat16()) and torch.equal(d_x, w_x)


def test_encode_bf16_table_rounds_once():
    """A bf16 table is read exactly, accumulated in fp32 and the output
    rounded once to bf16."""
    spec = BrickGridSpec(**_spec("3d_b2cells_F4", 15))
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.uniform(-1, 1, spec.table_shape).astype(np.float32))
    pos = torch.from_numpy(_boundary_points(spec, rng))
    out = brickgrid_encode(table.bfloat16(), pos, spec)
    want = brickgrid_encode_ref(table.bfloat16().float(), pos, spec).bfloat16()
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers (8 significant bits) at |x|."""
    a = np.maximum(np.abs(x.astype(np.float32)), np.float32(2.0 ** -126))
    return (2.0 ** (np.floor(np.log2(a)) - 7)).astype(np.float32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_encode_bf16_within_rounding_of_jax(variant):
    """bf16 tables: the port accumulates the live corners in fp32 and
    rounds once; JAX's ``_reduce_row`` sums the corner products in bf16, in
    an order XLA picks (queue 3, "bf16 accumulation", by design).  Bound,
    per output: (2^D / 2 + 2) bf16 ulps of s = sum_c w_c |f_c|, the largest
    any partial sum can reach: half an ulp for each of the 2^D - 1 bf16
    additions, one for the bf16 weights and products, half for the port's
    rounding.  Measured: 3 ulps (4D) and 2 (3D).  The port stays within
    half an ulp of its own fp32 encode of the same bf16 values."""
    kw = _spec(variant, 15)
    tspec, jspec = BrickGridSpec(**kw), JaxSpec(**kw)
    rng = np.random.default_rng(7 + sorted(VARIANTS).index(variant))
    table = torch.from_numpy(rng.uniform(-1.0, 1.0, tspec.table_shape).astype(np.float32))
    pos = torch.from_numpy(_boundary_points(tspec, rng))
    ours = brickgrid_encode(table.bfloat16(), pos, tspec)
    ref = np.asarray(jax_encode(jnp.asarray(table.numpy(), jnp.bfloat16), jnp.asarray(pos.numpy()),
                                jspec)).astype(np.float32)
    assert ours.dtype == torch.bfloat16 and ours.shape == ref.shape
    ours = ours.float().numpy()
    s = brickgrid_encode_ref(table.bfloat16().float().abs(), pos, tspec).numpy()
    ulps = np.abs(ours - ref) / bf16_ulp(s)
    assert ulps.max() <= 2 ** kw["n_input_dims"] / 2 + 2, ulps.max()
    assert (ulps > 0).any()  # the two packages do round differently
    exact = brickgrid_encode_ref(table.bfloat16().float(), pos, tspec).numpy()
    assert (np.abs(ours - exact) <= bf16_ulp(exact) / 2).all()


def _bf16_route_inputs(variant, seed):
    """fp32 table, boundary points and a bf16 cotangent of a variant."""
    tspec, jspec, table, pos, cot = _bwd_inputs(variant, seed)
    return tspec, jspec, torch.from_numpy(table), torch.from_numpy(pos), \
        torch.from_numpy(cot).bfloat16()


def _encode_and_grads(table, pos, cot, spec, compute_dtype, cast_first):
    """(encoding, table grad, position grad) through autograd: the fp32
    table with ``compute_dtype``, or ``table.to(compute_dtype)`` encoded
    (the route that made a bf16 copy of the table per call)."""
    t = table.clone().requires_grad_(True)
    x = pos.clone().requires_grad_(True)
    out = (brickgrid_encode(t.to(compute_dtype), x, spec) if cast_first
           else brickgrid_encode(t, x, spec, compute_dtype))
    out.backward(cot)
    return out.detach(), t.grad, x.grad


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fp32_table_with_bf16_compute_equals_cast_then_encode(variant):
    """The fp32 table with a bf16 computation gives, bit for bit, what
    encoding its bf16 cast gave: the encoding (bf16), the table gradient
    (fp32, already rounded to bf16 precision: float(bf16(.))) and the
    position gradient; so does the backward called directly."""
    tspec, _, table, pos, cot = _bf16_route_inputs(variant, 50 + sorted(VARIANTS).index(variant))
    out, d_t, d_x = _encode_and_grads(table, pos, cot, tspec, torch.bfloat16, False)
    want, w_t, w_x = _encode_and_grads(table, pos, cot, tspec, torch.bfloat16, True)
    assert out.dtype == torch.bfloat16 and d_t.dtype == torch.float32
    assert torch.equal(out, want)
    assert torch.equal(d_t, w_t) and torch.equal(d_t, d_t.bfloat16().float())
    assert torch.equal(d_x, w_x)
    direct_t, direct_x = brickgrid_encode_bwd_ref(table, pos, cot, tspec, True, torch.bfloat16)
    assert direct_t.dtype == torch.float32
    assert torch.equal(direct_t, d_t) and torch.equal(direct_x, d_x)
    assert (d_t != 0).any() and (d_x != 0).any()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bf16_compute_from_fp32_table_within_rounding_of_jax(variant):
    """The fp32 table with a bf16 computation against JAX's
    ``brickgrid_encode(table.astype(bf16))`` and its VJP (through the cast),
    with position gradients.  Encoding: the pinned bound of
    test_encode_bf16_within_rounding_of_jax.  Table gradient: both sum the
    same fp32 products (in another order) and round once to bf16, so they
    differ by at most one bf16 ulp of the larger plus the fp32 order bound
    of test_bwd_ref_matches_jax_vjp (1e-5 x max|grad|).  Position gradient:
    JAX forms it from bf16 reductions saved by the forward (bf16 weight
    derivatives, bf16 sums over the corners, the level scale in bf16), the
    port from fp32 sums of the same bf16 values; within 2^-5 x max|grad|.
    Measured: encodings 2-3 ulps, position gradients 3.8e-3 to 1.04e-2 x
    max|grad|."""
    tspec, jspec, table, pos, cot = _bf16_route_inputs(variant,
                                                       60 + sorted(VARIANTS).index(variant))
    out, d_t, d_x = _encode_and_grads(table, pos, cot, tspec, torch.bfloat16, False)
    ref, vjp = jax.vjp(lambda t, x: jax_encode(t.astype(jnp.bfloat16), x, jspec, True),
                       jnp.asarray(table.numpy()), jnp.asarray(pos.numpy()))
    # JAX's 3D F = 1 reduction returns fp32 (_reduce_row_lane), the others bf16
    r_t, r_x = (np.asarray(g) for g in vjp(jnp.asarray(cot.float().numpy(), ref.dtype)))
    assert r_t.dtype == np.float32 and r_t.shape == d_t.shape and r_x.shape == d_x.shape
    s = brickgrid_encode_ref(table.bfloat16().float().abs(), pos, tspec).numpy()
    ulps = np.abs(out.float().numpy() - np.asarray(ref).astype(np.float32)) / bf16_ulp(s)
    assert ulps.max() <= 2 ** tspec.n_input_dims / 2 + 2, ulps.max()
    d_t, d_x = d_t.numpy(), d_x.numpy()
    bound_t = bf16_ulp(np.maximum(np.abs(d_t), np.abs(r_t))) + 1e-5 * np.abs(r_t).max()
    assert (np.abs(d_t - r_t) <= bound_t).all(), np.abs(d_t - r_t).max()
    np.testing.assert_allclose(d_x, r_x, rtol=0, atol=2 ** -5 * np.abs(r_x).max())
    assert np.abs(r_x).max() > 1.0  # the position gradient is exercised


def test_encode_saves_the_stored_table_and_no_bf16_tensor():
    """With a bf16 computation on an fp32 table, the autograd graph keeps
    the table itself (no bf16 copy lives until the backward)."""
    tspec, _, table, pos, cot = _bf16_route_inputs("4d_pair_F8", 70)
    t = table.clone().requires_grad_(True)
    x = pos.clone().requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda v: saved.append(v) or v, lambda v: v):
        out = brickgrid_encode(t, x, tspec, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert [v.dtype for v in saved] == [torch.float32, torch.float32]
    assert saved[0].data_ptr() == t.data_ptr() and saved[1].data_ptr() == x.data_ptr()
    out.backward(cot)
    assert t.grad.dtype == torch.float32 and x.grad is not None


def _flagship_specs(jax_side: bool):
    cfg = flagship_config()
    m = cfg.nerf.model
    enc = cfg.nerf.propnet.xyz_encoder

    def make(**kw):
        if jax_side:
            return jax_builders.make_grid_spec("brick", perf=jax_builders._perf_cfg(cfg), **kw)
        return builders.make_grid_spec("brick", **kw)

    def from_enc(e):
        return make(n_input_dims=e.n_input_dims, n_levels=e.n_levels,
                    base_resolution=e.base_resolution, max_resolution=e.max_resolution,
                    log2_hashmap_size=e.log2_hashmap_size,
                    n_features_per_level=e.n_features_per_level)

    flow = make(n_input_dims=4, n_levels=10, base_resolution=16, max_resolution=4096,
                log2_hashmap_size=18, n_features_per_level=4)
    dyn = from_enc(m.dynamic_xyz_encoder)
    specs = {
        "static": from_enc(m.xyz_encoder),
        "dynflow": dataclasses.replace(
            dyn, n_features_per_level=dyn.n_features_per_level + flow.n_features_per_level),
    }
    for i in range(2):
        specs[f"prop{i}"] = make(
            n_input_dims=enc.n_input_dims, n_levels=enc.n_levels_per_prop[i],
            base_resolution=enc.base_resolutions_per_prop[i],
            max_resolution=enc.max_resolution_per_prop[i],
            log2_hashmap_size=enc.lgo2_hashmap_size_per_prop[i],
            n_features_per_level=enc.n_features_per_level)
    return specs


@pytest.mark.parametrize("name", ["static", "dynflow", "prop0", "prop1"])
def test_flagship_spec_geometry_matches_jax(name):
    ours, ref = _flagship_specs(False)[name], _flagship_specs(True)[name]
    assert ours.table_shape == ref.table_shape
    np.testing.assert_array_equal(np.float32(ours.level_scales), np.float32(ref.level_scales))
    np.testing.assert_array_equal(ours.level_resolutions, ref.level_resolutions)
    np.testing.assert_array_equal(ours.level_uses_hash, ref.level_uses_hash)
    for a, b in zip(level_constants(ours), jax_level_constants(ref)):
        np.testing.assert_array_equal(a, b)
    want_shapes = {"static": (1_310_720, 108), "dynflow": (327_680, 432),
                   "prop0": (131_072, 125), "prop1": (131_072, 125)}
    assert ours.table_shape == want_shapes[name]


@pytest.mark.parametrize("grid", ["dynamic", "flow"])
def test_reference_brick_warped_queries_match_jax_vjp(grid):
    """The tiny reference-brick flagship's separate dynamic and flow grids
    (unpaired 4D rows: two gathers per (point, level)) at flow-warped
    queries, as the unfused temporal aggregation makes them: positions
    anywhere in the unit cube (zeroed outside it), times moved by the frame
    step and clamped to exactly 0 or 1.  The port's grid_encode forward and
    its autograd VJP (table and position gradients, the latter only for
    warped queries) against JAX's grid_encode and its VJP with position
    gradients; tolerances as test_encode_ref_matches_jax and
    test_bwd_ref_matches_jax_vjp."""
    cfg, _, model, _, _ = build_flagship(tiny=True, profile=REFERENCE_BRICK, device="cpu")
    tspec = getattr(model, f"{grid}_spec")
    assert tspec.has_time and not tspec.uses_time_pair and not model.fused
    jspec = JaxSpec(**dataclasses.asdict(tspec))
    rng = np.random.default_rng(80 + len(grid))
    table = rng.uniform(-1.0, 1.0, tspec.table_shape).astype(np.float32)
    n = 512
    xyz = rng.uniform(-0.1, 1.1, (n, 3))
    xyz *= np.all((xyz >= 0) & (xyz <= 1), axis=-1, keepdims=True)  # contract_points' zeroing
    t = np.clip(rng.uniform(0, 1, (n, 1)) + rng.choice([-0.5, 0.0, 0.5], (n, 1)), 0.0, 1.0)
    pos = np.concatenate([xyz, t], -1).astype(np.float32)
    assert (pos[:, 3] == 0).any() and (pos[:, 3] == 1).any()
    cot = rng.normal(size=(n, tspec.n_output_dims)).astype(np.float32)
    tt = torch.from_numpy(table).requires_grad_(True)
    tx = torch.from_numpy(pos).requires_grad_(True)
    ours = grid_encode(tt, tx, tspec, torch.float32)
    d_t, d_x = torch.autograd.grad(ours, [tt, tx], torch.from_numpy(cot))
    ref, vjp = jax.vjp(lambda a, x: jax_grid_encode(a, x, jspec, True), jnp.asarray(table),
                       jnp.asarray(pos))
    ref_t, ref_x = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), ref_t, rtol=0, atol=1e-5 * np.abs(ref_t).max())
    np.testing.assert_allclose(d_x.numpy(), ref_x, rtol=0, atol=1e-6 * np.abs(ref_x).max())
    assert np.abs(ref_x[:, :3]).max() > 1.0  # the position gradient is exercised


def test_wrapper_checks_and_non_cuda_devices():
    spec = BrickGridSpec(**_spec("3d_b2cells_F4", 15))
    table = torch.zeros(spec.table_shape)
    with pytest.raises(ValueError):
        brickgrid_encode(table[:-1], torch.zeros(4, 3), spec)
    with pytest.raises(ValueError):
        brickgrid_encode(table, torch.zeros(4, 3, dtype=torch.float64), spec)
    with pytest.raises(ValueError):
        brickgrid_encode(table.to("meta"), torch.zeros(4, 3, device="meta"), spec)
    before = brickgrid_encode.launches
    brickgrid_encode(table, torch.zeros(4, 3), spec)
    assert brickgrid_encode.launches == before  # the plain version launches nothing
    assert kernels.dispatch_device("x", table) == "cpu"


@pytest.mark.parametrize("variant", ["3d_b2cells_F4", "3d_b4cells_F1", "4d_pair_F8"])
def test_coarse_view_matches_jax(variant):
    """A coarse view (``view_levels`` = 2 of 4, the table's first 2 levels)
    against JAX's ``view_levels`` spec: the forward and the VJP with
    position gradients, tolerances as test_encode_ref_matches_jax and
    test_bwd_ref_matches_jax_vjp.  The view's features are the full
    encode's first 2 levels bit for bit, and its kernel parameters carry
    the full spec's level geometry."""
    kw = _spec(variant, 15)
    full = BrickGridSpec(**kw)
    tspec, jspec = BrickGridSpec(**kw, view_levels=2), JaxSpec(**kw, view_levels=2)
    assert tspec.table_shape == jspec.table_shape == (2 * full.bricks_per_level, full.row_width)
    rng = np.random.default_rng(90 + sorted(VARIANTS).index(variant))
    table = rng.uniform(-1.0, 1.0, full.table_shape).astype(np.float32)
    view = table[:tspec.table_shape[0]]
    pos = _boundary_points(full, rng)
    cot = rng.normal(size=(pos.shape[0], tspec.n_output_dims)).astype(np.float32)
    tt = torch.from_numpy(view.copy()).requires_grad_(True)
    tx = torch.from_numpy(pos).requires_grad_(True)
    ours = brickgrid_encode(tt, tx, tspec)
    d_t, d_x = torch.autograd.grad(ours, [tt, tx], torch.from_numpy(cot))
    ref, vjp = jax.vjp(lambda t, x: jax_encode(t, x, jspec, True), jnp.asarray(view),
                       jnp.asarray(pos))
    ref_t, ref_x = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), ref_t, rtol=0, atol=1e-5 * np.abs(ref_t).max())
    np.testing.assert_allclose(d_x.numpy(), ref_x, rtol=0, atol=1e-6 * np.abs(ref_x).max())
    whole = brickgrid_encode(torch.from_numpy(table), torch.from_numpy(pos), full)
    assert torch.equal(ours.detach(), whole[:, :tspec.n_output_dims])
    params = _kernel_params(tspec)
    assert params.n_levels == 2 and params.grad_subsample == 1
    scales, strides, hashed = level_constants(full)
    assert list(params.scales[:2]) == [float(v) for v in scales[:2]]
    assert list(params.uses_hash[:2]) == [int(v) for v in hashed[:2]]


def _subsample_inputs(variant, k, seed, n=1000):
    kw = _spec(variant, 15)
    tspec = BrickGridSpec(**kw, grad_subsample=k)
    jspec = JaxSpec(**kw, grad_subsample=k)
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.0, 1.0, tspec.table_shape).astype(np.float32)
    pos = rng.uniform(0.0, 1.0, (n, kw["n_input_dims"])).astype(np.float32)
    cot = rng.normal(size=(n, tspec.n_output_dims)).astype(np.float32)
    return tspec, jspec, table, pos, cot


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("variant", ["3d_b2cells_F4", "3d_b4cells_F1", "4d_pair_F8"])
def test_grad_subsample_matches_jax_vjp(variant, k):
    """``grad_subsample`` k: the hashed levels' table gradient from points
    ``phase + j k`` (the phase from the bits of the first coordinate) times
    k, against JAX's VJP (table 1e-5 x the largest |grad|, positions 1e-6,
    as test_bwd_ref_matches_jax_vjp).  The dense levels' table gradient and
    the position gradient equal the unsubsampled ones bit for bit, and the
    hashed levels' differ (the stride engaged)."""
    tspec, jspec, table, pos, cot = _subsample_inputs(variant, k, 200 + k)
    tt = torch.from_numpy(table).requires_grad_(True)
    tx = torch.from_numpy(pos).requires_grad_(True)
    d_t, d_x = torch.autograd.grad(brickgrid_encode(tt, tx, tspec), [tt, tx],
                                   torch.from_numpy(cot))
    _, vjp = jax.vjp(lambda t, x: jax_encode(t, x, jspec, True), jnp.asarray(table),
                     jnp.asarray(pos))
    ref_t, ref_x = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    np.testing.assert_allclose(d_t.numpy(), ref_t, rtol=0, atol=1e-5 * np.abs(ref_t).max())
    np.testing.assert_allclose(d_x.numpy(), ref_x, rtol=0, atol=1e-6 * np.abs(ref_x).max())
    full_t, full_x = brickgrid_encode_bwd_ref(
        torch.from_numpy(table), torch.from_numpy(pos), torch.from_numpy(cot),
        dataclasses.replace(tspec, grad_subsample=1), True)
    assert torch.equal(d_x, full_x)
    b = tspec.bricks_per_level
    for lvl, hashed in enumerate(tspec.level_uses_hash):
        rows = slice(lvl * b, (lvl + 1) * b)
        assert torch.equal(d_t[rows], full_t[rows]) != bool(hashed), lvl


@pytest.mark.parametrize("k", [2, 4])
def test_grad_subsample_keeps_each_level_mass(k):
    """With a cotangent of ones each point adds weight 1 per feature and
    level, so every level's table gradient sums to n F with or without the
    stride (JAX's tests/test_brickgrid.py mass test); fewer than 2k points
    take every point."""
    tspec, _, table, pos, _ = _subsample_inputs("3d_b2cells_F4", k, 300 + k, n=128)
    ones = torch.ones(128, tspec.n_output_dims)
    d_t, _ = brickgrid_encode_bwd_ref(torch.from_numpy(table), torch.from_numpy(pos), ones,
                                      tspec, False)
    b, f = tspec.bricks_per_level, tspec.n_features_per_level
    for lvl in range(tspec.n_levels):
        assert np.isclose(float(d_t[lvl * b:(lvl + 1) * b].double().sum()), 128 * f, rtol=1e-5)
    few = torch.from_numpy(pos[:2 * k - 1])
    small, _ = brickgrid_encode_bwd_ref(torch.from_numpy(table), few, ones[:2 * k - 1], tspec,
                                        False)
    plain, _ = brickgrid_encode_bwd_ref(torch.from_numpy(table), few, ones[:2 * k - 1],
                                        dataclasses.replace(tspec, grad_subsample=1), False)
    assert torch.equal(small, plain)
    assert _kernel_params(tspec, effective_subsample(tspec, 128)).grad_subsample == k
    assert effective_subsample(tspec, 2 * k - 1) == 1


def test_grad_subsample_phase_is_read_from_the_first_coordinate():
    """The stride's phase is (bits(x[0, 0]) >> 9) % k, as JAX derives it."""
    x = torch.tensor([[0.3, 0.1, 0.7], [0.2, 0.5, 0.9]] * 8)
    bits = int(np.float32(0.3).view(np.uint32))
    rows = subsample_rows(x, 4)
    assert rows.tolist() == [(bits >> 9) % 4 + 4 * j for j in range(4)]
