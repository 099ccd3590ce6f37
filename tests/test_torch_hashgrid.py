"""Port parity: the plain versions of kernel K4 (emernerf_torch's exact hash
grid, forward and backward) against emernerf_tpu's ``hashgrid_encode``
(its custom VJP, forward and ``jax.vjp``) and ``hashgrid_encode_ref``
(autodiff of a gather), on the CPU in fp32.

Points sit on, just below and just above cell boundaries of every level
(where a differently rounded ``x * scale + 0.5`` picks another cell), at
x = 0 and at x = 1.0 (where a corner coordinate reaches the level's
resolution R).  Specs have both linear and hashed levels.

Tolerances, on tables U(-1, 1): the forward against the custom VJP, atol
1e-6 (sums of 2^D fp32 products; XLA may sum the corners in another
order); against the autodiff reference, atol 2e-6 (it multiplies the
weight factors in another order).  Table gradients rtol 1e-5 + 1e-6 x max
(fp32 scatter-adds in another order); position gradients rtol 1e-5 + 1e-5
x max (they reach ~10^3: the finest scales times the feature differences).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_ops import _hashgrid_oracle
from test_torch_brickgrid import bf16_ulp

from emernerf_tpu import builders as jax_builders
from emernerf_tpu.ops import hashgrid as jhg
from emernerf_torch import builders, kernels
from emernerf_torch.flagship import REFERENCE_HASH, flagship_config
from emernerf_torch.ops.hashgrid import (
    HashGridSpec,
    features_minor,
    hashgrid_encode,
    hashgrid_encode_bwd_plain,
    hashgrid_encode_plain,
    level_constants,
)

CASES = [(3, 1), (3, 2), (3, 4), (4, 1), (4, 2), (4, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec_kw(d, f):
    # 5 levels of R = 4 .. 128; T = 2^12: the coarse levels are linear
    return dict(n_input_dims=d, n_levels=5, base_resolution=4, max_resolution=128,
                log2_hashmap_size=12, n_features_per_level=f)


def _points(spec, rng, n_random=96):
    """Random points, cell boundaries of every level +-1 ulp, 0 and 1."""
    d = spec.n_input_dims
    pts = [rng.uniform(0.0, 1.0, (n_random, d)).astype(np.float32),
           np.zeros((1, d), np.float32), np.ones((1, d), np.float32)]
    for sc in np.asarray(spec.level_scales, np.float32):
        cells = rng.integers(1, int(sc) + 1, size=(24, d))
        x = ((cells - 0.5) / sc).astype(np.float32)
        for nudge in (-1, 0, 1):
            xn = np.nextafter(x, np.float32(nudge * np.inf)).astype(np.float32) if nudge else x
            pts.append(np.clip(xn, 0.0, 1.0))
    return np.concatenate(pts).astype(np.float32)


def _inputs(d, f, seed):
    kw = _spec_kw(d, f)
    tspec, jspec = HashGridSpec(**kw), jhg.HashGridSpec(**kw)
    assert tspec.level_uses_hash.any() and not tspec.level_uses_hash.all()
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.0, 1.0, tspec.table_shape).astype(np.float32)
    pos = _points(tspec, rng)
    return tspec, jspec, table, pos, rng


@pytest.mark.parametrize("d,f", CASES)
def test_forward_matches_jax(d, f):
    tspec, jspec, table, pos, _ = _inputs(d, f, 10 * d + f)
    ours = hashgrid_encode(torch.from_numpy(table), torch.from_numpy(pos), tspec).numpy()
    vjp = np.asarray(jhg.hashgrid_encode(jnp.asarray(table), jnp.asarray(pos), jspec))
    ref = np.asarray(jhg.hashgrid_encode_ref(jnp.asarray(table), jnp.asarray(pos), jspec))
    assert ours.shape == vjp.shape == (pos.shape[0], tspec.n_output_dims)
    np.testing.assert_allclose(ours, vjp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("d,f", CASES)
def test_gradients_match_jax(d, f):
    tspec, jspec, table, pos, rng = _inputs(d, f, 100 + 10 * d + f)
    g = rng.normal(size=(pos.shape[0], tspec.n_output_dims)).astype(np.float32)
    _, vjp = jax.vjp(lambda t, x: jhg.hashgrid_encode(t, x, jspec), jnp.asarray(table),
                     jnp.asarray(pos))
    _, vjp_ref = jax.vjp(lambda t, x: jhg.hashgrid_encode_ref(t, x, jspec), jnp.asarray(table),
                         jnp.asarray(pos))
    tt = torch.from_numpy(table).requires_grad_(True)
    xx = torch.from_numpy(pos).requires_grad_(True)
    hashgrid_encode(tt, xx, tspec).backward(torch.from_numpy(g))
    for d_t, d_x in (vjp(jnp.asarray(g)), vjp_ref(jnp.asarray(g))):
        d_t, d_x = np.asarray(d_t), np.asarray(d_x)
        np.testing.assert_allclose(tt.grad.numpy(), d_t, rtol=1e-5,
                                   atol=1e-6 * np.abs(d_t).max())
        np.testing.assert_allclose(xx.grad.numpy(), d_x, rtol=1e-5,
                                   atol=1e-5 * np.abs(d_x).max())
    assert np.abs(d_x).max() > 1.0  # the position gradient is exercised


def test_position_gradient_only_where_required():
    tspec, _, table, pos, rng = _inputs(4, 2, 7)
    tt = torch.from_numpy(table).requires_grad_(True)
    hashgrid_encode(tt, torch.from_numpy(pos), tspec).sum().backward()
    d_t, d_x = hashgrid_encode_bwd_plain(torch.from_numpy(table), torch.from_numpy(pos),
                                         torch.ones(pos.shape[0], tspec.n_output_dims),
                                         tspec, needs_pos_grad=False)
    assert d_x is None and torch.equal(tt.grad, d_t)


@pytest.mark.parametrize("dims", [3, 4])
def test_plain_version_matches_numpy_oracle(dims):
    """tests/test_ops.py's independent float64 numpy oracle, on random
    points (its float64 cell math may pick another cell on a boundary);
    atol 1e-5: fp32 against float64 fractions and sums."""
    spec = HashGridSpec(n_input_dims=dims, n_levels=4, base_resolution=4, max_resolution=64,
                        log2_hashmap_size=9, n_features_per_level=2)
    rng = np.random.default_rng(dims)
    table = rng.uniform(-1, 1, spec.table_shape).astype(np.float32)
    x = rng.uniform(0, 1, (64, dims)).astype(np.float32)
    got = hashgrid_encode_plain(torch.from_numpy(table), torch.from_numpy(x), spec)
    np.testing.assert_allclose(got.numpy(), _hashgrid_oracle(table, x, spec), rtol=1e-4,
                               atol=1e-5)


def _full_width_specs(port: bool):
    """The five grids of the full-width reference-hash flagship."""
    cfg = flagship_config(profile=REFERENCE_HASH)
    m, enc = cfg.nerf.model, cfg.nerf.propnet.xyz_encoder

    def make(**kw):
        return (builders.make_grid_spec("hash", **kw) if port
                else jax_builders.make_grid_spec("hash", **kw))

    def from_enc(e):
        return make(n_input_dims=e.n_input_dims, n_levels=e.n_levels,
                    base_resolution=e.base_resolution, max_resolution=e.max_resolution,
                    log2_hashmap_size=e.log2_hashmap_size,
                    n_features_per_level=e.n_features_per_level)

    specs = {"static": from_enc(m.xyz_encoder), "dynamic": from_enc(m.dynamic_xyz_encoder),
             "flow": make(n_input_dims=4, n_levels=10, base_resolution=16,
                          max_resolution=4096, log2_hashmap_size=18, n_features_per_level=4)}
    for i in range(2):
        specs[f"prop{i}"] = make(
            n_input_dims=enc.n_input_dims, n_levels=enc.n_levels_per_prop[i],
            base_resolution=enc.base_resolutions_per_prop[i],
            max_resolution=enc.max_resolution_per_prop[i],
            log2_hashmap_size=enc.lgo2_hashmap_size_per_prop[i],
            n_features_per_level=enc.n_features_per_level)
    return specs


@pytest.mark.parametrize("name", ["static", "dynamic", "flow", "prop0", "prop1"])
def test_full_width_level_constants_match_jax(name):
    ours, ref = _full_width_specs(True)[name], _full_width_specs(False)[name]
    assert ours.table_shape == ref.table_shape
    np.testing.assert_array_equal(np.float32(ours.level_scales), np.float32(ref.level_scales))
    np.testing.assert_array_equal(ours.level_resolutions, ref.level_resolutions)
    np.testing.assert_array_equal(ours.level_uses_hash, ref.level_uses_hash)
    for a, b in zip(level_constants(ours), jhg._level_constants(ref)):
        np.testing.assert_array_equal(a, b)
    linear = {"static": 3, "dynamic": 0, "flow": 1}.get(name)
    if linear is not None:
        assert int((~ours.level_uses_hash).sum()) == linear
    if name == "static":
        # float64 30.999999999999996 -> float32 31.0; resolution ceil + 1 = 32
        assert ours.level_scales[1] < 31.0 and np.float32(ours.level_scales[1]) == 31.0
        assert ours.level_resolutions[1] == 32 == math.ceil(ours.level_scales[1]) + 1


def test_bf16_table_rounds_once():
    tspec, _, table, pos, _ = _inputs(3, 4, 5)
    t = torch.from_numpy(table)
    out = hashgrid_encode(t.bfloat16(), torch.from_numpy(pos), tspec)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, hashgrid_encode_plain(t.bfloat16().float(), torch.from_numpy(pos),
                                                  tspec).bfloat16())


@pytest.mark.parametrize("d,f", CASES)
def test_bf16_within_rounding_of_jax(d, f):
    """bf16 tables: the port sums the 2^D corners in fp32 and rounds once;
    JAX casts the weights to bf16 and sums the corner products in bf16
    (queue 3, "bf16 accumulation", by design).  The bound of
    tests/test_torch_brickgrid.py, (2^D / 2 + 2) bf16 ulps of
    s = sum_c w_c |f_c| per output; measured: 1 ulp."""
    tspec, jspec, table, pos, _ = _inputs(d, f, 20 + 10 * d + f)
    t16, x = torch.from_numpy(table).bfloat16(), torch.from_numpy(pos)
    ours = hashgrid_encode(t16, x, tspec)
    ref = np.asarray(jhg.hashgrid_encode(jnp.asarray(table, jnp.bfloat16), jnp.asarray(pos),
                                         jspec))
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ours, ref = ours.float().numpy(), ref.astype(np.float32)
    s = hashgrid_encode_plain(t16.float().abs(), x, tspec).numpy()
    ulps = np.abs(ours - ref) / bf16_ulp(s)
    assert ulps.max() <= 2 ** d / 2 + 2, ulps.max()
    assert (ulps > 0).any()


def test_wrapper_checks_and_non_cuda_devices():
    spec = HashGridSpec(**_spec_kw(3, 2))
    table = torch.zeros(spec.table_shape)
    with pytest.raises(ValueError):
        hashgrid_encode(table[:, :-1], torch.zeros(4, 3), spec)
    with pytest.raises(ValueError):
        hashgrid_encode(table, torch.zeros(4, 3, dtype=torch.float64), spec)
    with pytest.raises(ValueError):
        hashgrid_encode(table.to("meta"), torch.zeros(4, 3, device="meta"), spec)
    before = hashgrid_encode.launches
    hashgrid_encode(table, torch.zeros(4, 3), spec)
    assert hashgrid_encode.launches == before  # the plain version launches nothing
    assert kernels.dispatch_device("x", table) == "cpu"


@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_features_minor_copy(f, dtype):
    """The table K4's kernels read: element [r, f] is table[f, r], in the
    table's dtype and contiguous; an F = 1 table is already features-minor
    and is viewed, not copied."""
    spec = HashGridSpec(**_spec_kw(4, f))
    rng = np.random.default_rng(f)
    table = torch.from_numpy(rng.uniform(-1, 1, spec.table_shape).astype(np.float32)).to(dtype)
    fm = features_minor(table)
    rows = spec.table_shape[1]
    assert fm.shape == (rows, f) and fm.dtype == dtype and fm.is_contiguous()
    r = torch.from_numpy(rng.integers(0, rows, 500))
    for fi in range(f):
        assert torch.equal(fm[r, fi], table[fi, r])
    assert torch.equal(fm.flatten(), table.t().flatten())
    assert (fm.data_ptr() == table.data_ptr()) == (f == 1)
