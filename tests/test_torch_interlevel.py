"""Port parity: the interlevel loss (plain versions of kernel K5) against
``emernerf_tpu.render.prop_sampler.compute_prop_loss``, value and gradient
w.r.t. the proposal CDFs, on the CPU in fp32; the grouped form over every
cache level (``interlevel_loss_levels``, one launch per branch on the
card) against the one-level plain version, bit for bit, and its argument
checks.

Tolerance: the blurred pdf is a cumsum of jumps |y| / (2r) that cancel,
so its fp32 rounding is ~1e-7 x max|y| / r in either package (both sit
~1e-4 from a float64 evaluation at these inputs); it is compared with
atol 1e-8 x max|y| / r.  The loss: rtol 1e-5.  Its gradient, per cache
level: rtol 1e-4, atol 1e-5 x the largest |grad|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emernerf_tpu.ops.stepfuns import blur_stepfun as jax_blur
from emernerf_tpu.ops.stepfuns import sorted_interp_quad as jax_interp
from emernerf_tpu.render.prop_sampler import PropCache as JaxPropCache
from emernerf_tpu.render.prop_sampler import compute_prop_loss as jax_prop_loss
from emernerf_torch.ops.stepfuns import (
    blur_stepfun,
    interlevel_loss,
    interlevel_loss_bwd,
    interlevel_loss_bwd_ref,
    interlevel_loss_levels,
    interlevel_loss_levels_bwd,
    interlevel_loss_levels_ref,
    interlevel_loss_ref,
    sorted_interp_quad,
)
from emernerf_torch.render.prop_sampler import PropCache, compute_prop_loss

R, K = 24, 16
LEVELS = (12, 8)  # intervals per proposal level


def _edges(rng, n):
    s = np.sort(rng.uniform(0, 1, (R, n + 1)), -1)
    s[:, 0], s[:, -1] = 0.0, 1.0
    return s.astype(np.float32)


def _cdfs(rng, n):
    w = rng.exponential(1.0, (R, n)) * (rng.uniform(0, 1, (R, n)) < 0.7)
    c = np.concatenate([np.zeros((R, 1)), np.cumsum(w, -1)], -1)
    return (c / c[:, -1:] * rng.uniform(0.5, 1.0, (R, 1))).astype(np.float32)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    s_final = _edges(rng, K)
    trans = np.concatenate([np.ones((R, 1)), 1.0 - _cdfs(rng, K - 1)[:, 1:]], -1)
    caches = [(_edges(rng, n), _cdfs(rng, n)) for n in LEVELS]
    return s_final, trans.astype(np.float32), caches


@pytest.mark.parametrize("r", [0.03, 0.003])
def test_blur_and_interp_match_jax(r):
    s_final, trans, caches = _inputs(1)
    y = np.diff(1.0 - np.concatenate([trans, np.zeros((R, 1), np.float32)], -1), axis=-1) / np.diff(
        s_final, axis=-1)
    jc, jw = jax_blur(jnp.asarray(s_final), jnp.asarray(y), r)
    c, w = blur_stepfun(torch.from_numpy(s_final), torch.from_numpy(y), r)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-8 * np.abs(y).max() / r)
    f = np.cumsum(np.asarray(jw), -1).astype(np.float32)
    ref = jax_interp(jnp.asarray(caches[0][0]), jc, jw, jnp.asarray(f))
    ours = sorted_interp_quad(torch.from_numpy(caches[0][0]), c, w, torch.from_numpy(f))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("anti_aliasing", [True, False], ids=["zipnerf", "mipnerf360"])
def test_prop_loss_and_grad_match_jax(anti_aliasing):
    s_final, trans, caches = _inputs(2)

    def jax_loss(cdfs_list):
        cs = [JaxPropCache(jnp.asarray(s), c, i) for i, ((s, _), c) in
              enumerate(zip(caches, cdfs_list))]
        return jax_prop_loss(cs, jnp.asarray(s_final), jnp.asarray(trans), anti_aliasing,
                             (0.03, 0.003), 1024.0)

    ref, ref_grads = jax.value_and_grad(jax_loss)([jnp.asarray(c) for _, c in caches])
    cdfs = [torch.from_numpy(c).requires_grad_(True) for _, c in caches]
    loss = compute_prop_loss(
        [PropCache(torch.from_numpy(s), c, i) for i, ((s, _), c) in enumerate(zip(caches, cdfs))],
        torch.from_numpy(s_final), torch.from_numpy(trans), anti_aliasing, (0.03, 0.003), 1024.0)
    loss.backward()
    assert float(ref) > 0
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)
    for c, g in zip(cdfs, ref_grads):
        g = np.asarray(g)
        np.testing.assert_allclose(c.grad.numpy(), g, rtol=1e-4, atol=1e-5 * np.abs(g).max())


def test_interlevel_backward_is_the_autograd_of_the_plain_forward():
    s_final, trans, caches = _inputs(3)
    s, c = (torch.from_numpy(a) for a in caches[1])
    g = torch.from_numpy(np.random.default_rng(0).uniform(0.5, 2.0, R).astype(np.float32))
    c_leaf = c.clone().requires_grad_(True)
    _, loss = interlevel_loss_ref(torch.from_numpy(s_final), torch.from_numpy(trans), 0.003,
                                  s, c_leaf)
    (auto,) = torch.autograd.grad(loss, c_leaf, g)
    w_s, _ = interlevel_loss_ref(torch.from_numpy(s_final), torch.from_numpy(trans), 0.003, s, c)
    torch.testing.assert_close(interlevel_loss_bwd(w_s, c, g), auto, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="only cache_cdfs"):
        interlevel_loss(s.requires_grad_(True), c, torch.from_numpy(s_final),
                        torch.from_numpy(trans), 0.003)


@pytest.mark.parametrize("levels,radii", [((12,), (0.003,)), ((12, 8), (0.03, 0.003)),
                                          ((8, 12), (0.003, 0.03))],
                         ids=["one_level", "two_levels", "two_levels_swapped"])
def test_levels_ref_is_the_one_level_ref_level_by_level(levels, radii):
    rng = np.random.default_rng(4)
    s_final = torch.from_numpy(_edges(rng, K))
    trans = torch.from_numpy(
        np.concatenate([np.ones((R, 1)), 1.0 - _cdfs(rng, K - 1)[:, 1:]], -1).astype(np.float32))
    caches = [(torch.from_numpy(_edges(rng, n)), torch.from_numpy(_cdfs(rng, n))) for n in levels]
    w_s, loss = interlevel_loss_levels_ref([s for s, _ in caches], [c for _, c in caches],
                                           s_final, trans, radii)
    assert loss.shape == (len(levels), R) and len(w_s) == len(levels)
    for l, ((s, c), r) in enumerate(zip(caches, radii)):
        w_one, loss_one = interlevel_loss_ref(s_final, trans, r, s, c)
        assert torch.equal(w_s[l], w_one) and torch.equal(loss[l], loss_one)
    # the wrapper (plain versions on the CPU) and its gradient, level by level
    cdfs = [c.clone().requires_grad_(True) for _, c in caches]
    g = torch.from_numpy(rng.uniform(0.5, 2.0, (len(levels), R)).astype(np.float32))
    out = interlevel_loss_levels([s for s, _ in caches], cdfs, s_final, trans, radii)
    assert torch.equal(out.detach(), loss)
    out.backward(g)
    for l, ((s, c), r) in enumerate(zip(caches, radii)):
        assert torch.equal(cdfs[l].grad, interlevel_loss_bwd_ref(w_s[l], c, g[l]))
    d = interlevel_loss_levels_bwd(w_s, [c for _, c in caches], g[:, :1].expand(-1, R))
    for l, (_, c) in enumerate(caches):
        assert torch.equal(d[l], interlevel_loss_bwd_ref(w_s[l], c, g[l, :1].expand(R)))


@pytest.mark.parametrize("levels", [(12,), (12, 8, 20)], ids=["one_level", "three_levels"])
def test_grouped_prop_loss_and_grad_match_jax(levels):
    """compute_prop_loss's one grouped call at other level counts than the
    flagship's two: each level's gradient rtol 1e-4 + 1e-5 x its largest
    |grad|; the loss rtol 1e-5, widened by the reference's own distance from
    a float64 evaluation: the blurred pdf's cancelling fp32 sums leave both
    packages ~5e-5 from float64 at one level of r = 0.03 here, in other
    directions (XLA's cumsum accumulates in fp32, torch's on the CPU in
    float64)."""
    rng = np.random.default_rng(5)
    s_final = _edges(rng, K)
    trans = np.concatenate([np.ones((R, 1)), 1.0 - _cdfs(rng, K - 1)[:, 1:]], -1).astype(
        np.float32)
    caches = [(_edges(rng, n), _cdfs(rng, n)) for n in levels]
    widths = (0.03, 0.003, 0.01)

    def jax_loss(cdfs_list):
        cs = [JaxPropCache(jnp.asarray(s), c, i) for i, ((s, _), c) in
              enumerate(zip(caches, cdfs_list))]
        return jax_prop_loss(cs, jnp.asarray(s_final), jnp.asarray(trans), True, widths, 1024.0)

    ref, ref_grads = jax.value_and_grad(jax_loss)([jnp.asarray(c) for _, c in caches])
    cdfs = [torch.from_numpy(c).requires_grad_(True) for _, c in caches]
    loss = compute_prop_loss(
        [PropCache(torch.from_numpy(s), c, i) for i, ((s, _), c) in enumerate(zip(caches, cdfs))],
        torch.from_numpy(s_final), torch.from_numpy(trans), True, widths, 1024.0)
    loss.backward()
    f64 = [torch.from_numpy(a).double() for a in (s_final, trans)]
    _, per_ray = interlevel_loss_levels_ref([torch.from_numpy(s).double() for s, _ in caches],
                                            [torch.from_numpy(c).double() for _, c in caches],
                                            *f64, widths[:len(levels)])
    exact = 1024.0 * sum(float(p.sum()) / (R * n) for p, n in zip(per_ray, levels))
    assert float(ref) > 0
    assert abs(loss.item() - float(ref)) <= 1e-5 * float(ref) + abs(float(ref) - exact)
    for c, g in zip(cdfs, ref_grads):
        g = np.asarray(g)
        np.testing.assert_allclose(c.grad.numpy(), g, rtol=1e-4, atol=1e-5 * np.abs(g).max())


def _bad_levels(case):
    """Arguments of interlevel_loss_levels, broken as ``case`` says."""
    rng = np.random.default_rng(6)
    s_final = torch.from_numpy(_edges(rng, K))
    trans = torch.from_numpy(1.0 - _cdfs(rng, K)[:, 1:])
    caches_s = [torch.from_numpy(_edges(rng, n)) for n in LEVELS]
    cdfs = [torch.from_numpy(_cdfs(rng, n)) for n in LEVELS]
    radii = [0.03, 0.003]
    if case == "edges_and_cdfs_disagree":
        cdfs[1] = cdfs[1][:, :-1]
    elif case == "levels_disagree_on_rays":
        caches_s[1], cdfs[1] = caches_s[1][:-1], cdfs[1][:-1]
    elif case == "radius_count":
        radii = radii[:1]
    elif case == "cdf_count":
        cdfs = cdfs[:1]
    elif case == "too_many_edges":
        caches_s[0] = torch.linspace(0, 1, 258).expand(R, -1).contiguous()
        cdfs[0] = caches_s[0].clone()
    elif case.startswith("grad_of_"):
        what = case[len("grad_of_"):]
        if what == "cache_s":
            caches_s[0].requires_grad_(True)
        else:
            {"s_final": s_final, "trans_final": trans}[what].requires_grad_(True)
    return caches_s, cdfs, s_final, trans, radii


@pytest.mark.parametrize("case,match", [
    ("edges_and_cdfs_disagree", "cache edges and CDFs"),
    ("levels_disagree_on_rays", "cache edges and CDFs"),
    ("radius_count", "one radius per cache level"),
    ("cdf_count", "cache edges and CDFs for each"),
    ("too_many_edges", "edges per ray"),
    ("grad_of_cache_s", "only cache_cdfs"),
    ("grad_of_s_final", "only cache_cdfs"),
    ("grad_of_trans_final", "only cache_cdfs"),
])
def test_grouped_interlevel_refuses_bad_arguments(case, match):
    caches_s, cdfs, s_final, trans, radii = _bad_levels(case)
    with pytest.raises(ValueError, match=match):
        interlevel_loss_levels(caches_s, cdfs, s_final, trans, radii)
    # the same arguments, unbroken, are taken
    caches_s, cdfs, s_final, trans, radii = _bad_levels("none")
    assert interlevel_loss_levels(caches_s, cdfs, s_final, trans, radii).shape == (2, R)
