"""Port parity for the gradients of kernels K1 and K3 (their plain versions
under the port's autograd.Functions) against JAX autodiff, on the CPU in
fp32.  The tie gradients of the clip are pinned in test_torch_volrend.py.

K1: the table and position gradients of ``brickgrid_encode`` against
``jax.vjp`` of emernerf_tpu's custom-VJP ``brickgrid_encode`` (with
position grads), for the three table layouts the flagship trains: F=1 with
4^3-cell bricks (proposal grids), F=4 with 2^3-cell bricks (static grid)
and F=8 time-paired 4D rows (the fused dynamic+flow grid).  Tolerance: atol
1e-5 x the largest |grad| (table: sums of up to a few hundred products in
another order; positions: the reference reads forward-saved reductions,
the port re-reads the corners).

K3: the gradient of a random weighted sum of every ``composite_rays``
output w.r.t. the densities and values, rtol 1e-4, atol 1e-5 x the
largest |grad|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emernerf_tpu.ops.brickgrid import BrickGridSpec as JaxSpec
from emernerf_tpu.ops.brickgrid import brickgrid_encode as jax_encode
from emernerf_tpu.render.volrend import composite_rays as jax_composite
from emernerf_torch.ops.brickgrid import BrickGridSpec, brickgrid_encode
from emernerf_torch.render.volrend import composite_rays

LAYOUTS = {
    "prop_F1_4cube": (3, 1, 2, False),
    "static_F4": (3, 4, 1, False),
    "dynflow_F8_pair": (4, 8, 1, True),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_brickgrid_grads_match_jax_vjp(layout):
    d, f, bs, pair = LAYOUTS[layout]
    kw = dict(n_input_dims=d, n_levels=4, base_resolution=4, max_resolution=64,
              log2_bricks=12 - 3 * bs, n_features_per_level=f, log2_brick_size=bs,
              time_pair=pair)
    tspec, jspec = BrickGridSpec(**kw), JaxSpec(**kw)
    rng = np.random.default_rng(sorted(LAYOUTS).index(layout))
    table = rng.uniform(-1.0, 1.0, tspec.table_shape).astype(np.float32)
    pos = rng.uniform(0.0, 1.0, (40, 8, d)).astype(np.float32)
    cot = rng.normal(size=(40, 8, tspec.n_output_dims)).astype(np.float32)
    _, vjp = jax.vjp(lambda t, x: jax_encode(t, x, jspec, True), jnp.asarray(table),
                     jnp.asarray(pos))
    ref_t, ref_x = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    t = torch.from_numpy(table).requires_grad_(True)
    x = torch.from_numpy(pos).requires_grad_(True)
    brickgrid_encode(t, x, tspec).backward(torch.from_numpy(cot))
    for ours, ref in ((t.grad, ref_t), (x.grad, ref_x)):
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert np.abs(ref_x).max() > 0 and np.count_nonzero(ref_t) > 0


def test_brickgrid_table_grad_in_table_dtype_and_no_position_grad():
    spec = BrickGridSpec(n_input_dims=3, n_levels=2, base_resolution=4, max_resolution=16,
                         log2_bricks=6, n_features_per_level=4)
    table = torch.zeros(spec.table_shape, dtype=torch.bfloat16, requires_grad=True)
    x = torch.rand(64, 3)
    brickgrid_encode(table, x, spec).float().sum().backward()
    assert table.grad.dtype == torch.bfloat16 and x.grad is None
    # every point's trilinear weights sum to 1 per level and feature
    assert abs(float(table.grad.float().sum()) - 64 * 2 * 4) < 1.0


def _field_outputs(rng, r=32, s=24):
    t = np.sort(rng.uniform(0.5, 60.0, (r, s + 1)).astype(np.float32), -1)
    static = rng.exponential(0.05, (r, s)).astype(np.float32)
    dynamic = rng.exponential(0.02, (r, s)).astype(np.float32)
    static[:3] = 0.0  # empty rays: opacity clipped to 1e-6
    static[3:6, 5] = 50.0  # opaque rays
    res = {"density": static + dynamic, "static_density": static,
           "dynamic_density": dynamic, "static_rgb": rng.uniform(0, 1, (r, s, 3)),
           "dynamic_rgb": rng.uniform(0, 1, (r, s, 3)),
           "shadow_ratio": rng.uniform(0, 1, (r, s, 1)), "rgb_sky": rng.uniform(0, 1, (r, 3))}
    return t[:, :-1].copy(), t[:, 1:].copy(), {k: np.asarray(v, np.float32)
                                               for k, v in res.items()}


@pytest.mark.parametrize("decomp", [False, True], ids=["train", "decomposition"])
def test_composite_grads_match_jax(decomp):
    rng = np.random.default_rng(7 + decomp)
    ts, te, res = _field_outputs(rng)
    keys = ["rgb", "depth", "opacity", "shadow_ratio"] + (
        ["static_rgb", "dynamic_rgb", "static_depth", "dynamic_opacity"] if decomp else [])
    coef = {k: rng.normal(size=(32, 3 if "rgb" in k else 1)).astype(np.float32) for k in keys}
    wco = rng.normal(size=(32, 24)).astype(np.float32)

    def jax_loss(r):
        out = jax_composite(jnp.asarray(ts), jnp.asarray(te), r, return_decomposition=decomp)
        return (sum((out[k] * coef[k]).sum() for k in keys)
                + (out["extras"]["weights"] * wco).sum() + (out["extras"]["trans"] * wco).sum())

    ref = jax.grad(jax_loss)({k: jnp.asarray(v) for k, v in res.items()})
    leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in res.items()}
    out = composite_rays(torch.from_numpy(ts), torch.from_numpy(te), leaves,
                         return_decomposition=decomp)
    loss = (sum((out[k] * torch.from_numpy(coef[k])).sum() for k in keys)
            + (out["extras"]["weights"] * torch.from_numpy(wco)).sum()
            + (out["extras"]["trans"] * torch.from_numpy(wco)).sum())
    loss.backward()
    for k, leaf in leaves.items():
        g = np.asarray(ref[k])
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)
