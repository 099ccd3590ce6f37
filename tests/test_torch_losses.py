"""Port parity: the training losses against ``emernerf_tpu.losses.losses``,
values and gradients, on the CPU in fp32, including inputs that sit on a
clip bound (a zero depth, an opacity of 1e-6) where JAX passes half the
gradient.  Tolerance: rtol 1e-5 on values, rtol 1e-5 and
atol 1e-6 x the largest |grad| on gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emernerf_tpu.losses import losses as jl
from emernerf_torch.losses import losses as tl

R, S = 48, 16


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = dict(
        pred=rng.uniform(0, 1, (R, 3)).astype(f32), gt=rng.uniform(0, 1, (R, 3)).astype(f32),
        mask=(rng.uniform(0, 1, (R, 3)) < 0.6).astype(f32),
        weights=rng.uniform(0, 0.2, (R, S)).astype(f32),
        sky=(rng.uniform(0, 1, R) < 0.3).astype(f32),
        opacity=rng.uniform(0, 1, (R, 1)).astype(f32),
        depth=rng.uniform(0, 100, (R, 1)).astype(f32),
        ranges=rng.uniform(-1, 90, R).astype(f32),
        t_vals=np.sort(rng.uniform(0.1, 90, (R, S)), -1).astype(f32),
        dyn=rng.exponential(0.1, (R, S)).astype(f32),
        stat=rng.exponential(0.1, (R, S)).astype(f32),
        flows=[rng.normal(size=(R, S, 3)).astype(f32) for _ in range(4)],
        agg=(rng.uniform(0, 1, (R, S)) < 0.3).astype(f32),
    )
    x["opacity"][:3] = [[1e-6], [1.0], [0.5]]
    x["depth"][0] = 0.0  # an empty ray: normalize_depth's clip at its bound
    x["ranges"][:5] = [30.0, 50.0, 85.0, 0.005, 0.0]
    x["dyn"][0, :2] = 0.0
    return x


def _cases(x):
    """(name, differentiated input names, fn(lib, inputs) -> scalar)."""
    return [
        ("rgb_l2", ["pred"], lambda L, v: L.real_value_loss(v["pred"], v["gt"], "l2", 1.0)),
        ("rgb_l1_masked", ["pred"],
         lambda L, v: L.real_value_loss(v["pred"], v["gt"], "l1", 0.5, v["mask"])),
        ("rgb_smooth_l1", ["pred"],
         lambda L, v: L.real_value_loss(v["pred"] * 4, v["gt"], "smooth_l1", 1.0)),
        ("sky_weights", ["weights"], lambda L, v: L.sky_loss_weights(v["weights"], v["sky"], 0.01)),
        ("sky_opacity", ["opacity"], lambda L, v: L.sky_loss_opacity(v["opacity"], v["sky"], 1e-3)),
        ("depth", ["depth"], lambda L, v: L.depth_loss(v["depth"], v["ranges"], "l2", 1.0, 80.0)),
        ("line_of_sight", ["weights"], lambda L, v: L.line_of_sight_loss(
            v["ranges"], v["weights"], v["t_vals"], 4.25, 0.1, 0.5)),
        ("dynamic_sparsity", ["dyn"], lambda L, v: L.dynamic_regularization_loss(
            v["dyn"], v["stat"], v["sky"], "sparsity", 0.01)),
        ("dynamic_entropy", ["dyn", "stat"], lambda L, v: L.dynamic_regularization_loss(
            v["dyn"], v["stat"], None, "entropy", 0.01, 1.1)),
        ("cycle_masked", ["f1", "f3"], lambda L, v: L.cycle_consistency_loss(
            v["f0"], v["f1"], v["f2"], v["f3"], 0.01, v["agg"])),
        ("cycle", ["f0", "f1", "f3"], lambda L, v: L.cycle_consistency_loss(
            v["f0"], v["f1"], v["f2"], v["f3"], 0.01)),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _cases(None)])
def test_loss_and_grad_match_jax(case):
    x = _inputs(0)
    flat = {k: v for k, v in x.items() if k != "flows"}
    flat.update({f"f{i}": f for i, f in enumerate(x["flows"])})
    name, wrt, fn = next(c for c in _cases(x) if c[0] == case)

    def jfn(diff):
        return fn(jl, {**{k: jnp.asarray(v) for k, v in flat.items()}, **diff})

    ref, ref_g = jax.value_and_grad(jfn)({k: jnp.asarray(flat[k]) for k in wrt})
    tv = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    for k in wrt:
        tv[k].requires_grad_(True)
    ours = fn(tl, tv)
    ours.backward()
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5, err_msg=name)
    for k in wrt:
        g = np.asarray(ref_g[k])
        got = torch.zeros_like(tv[k]) if tv[k].grad is None else tv[k].grad  # detached input
        np.testing.assert_allclose(got.numpy(), g, rtol=1e-5,
                                   atol=1e-6 * np.abs(g).max(), err_msg=f"{name} d/d{k}")
