"""Port parity: emernerf_torch compositing (plain version of kernel K3)
against emernerf_tpu.render.volrend.composite_rays, on the CPU in fp32.

Tolerance: atol 1e-5 (sums of 64 weighted fp32 terms, other order).
Median depth is ``count(cumsum(w) < 0.5)``: where the cumsum sits within
~1e-6 of 0.5, a different summation order may move it by one sample, so a
ray may differ by one sample exactly there.

The clip's tie gradient: an opaque ray whose opacity is exactly 1.0 in
fp32, and a sky ray at opacity 1e-6, against ``jax.grad`` (jnp.clip passes
half the cotangent at a bound, torch.clamp all of it); rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emernerf_tpu.losses.losses import sky_loss_opacity as jax_sky_loss
from emernerf_tpu.render.volrend import composite_rays as jax_composite
from emernerf_torch.losses.losses import sky_loss_opacity
from emernerf_torch.render.volrend import (
    composite_along_rays,
    composite_along_rays_bwd,
    composite_rays,
    pack_chan_sets,
    weights_opacity_depth_from_density,
)

R, S = 48, 64


def _field_outputs(rng, keys):
    t = np.sort(rng.uniform(0.5, 80.0, (R, S + 1)).astype(np.float32), -1)
    static = rng.exponential(0.05, (R, S)).astype(np.float32)
    dynamic = rng.exponential(0.02, (R, S)).astype(np.float32)
    static[:4] = 0.0  # empty rays: opacity clipped to 1e-6
    dynamic[:6] = 0.0
    res = {
        "density": static + dynamic,
        "static_density": static,
        "dynamic_density": dynamic,
        "static_rgb": rng.uniform(0, 1, (R, S, 3)),
        "dynamic_rgb": rng.uniform(0, 1, (R, S, 3)),
    }
    if "shadow" in keys:
        res["shadow_ratio"] = rng.uniform(0, 1, (R, S, 1))
    if "sky" in keys:
        res["rgb_sky"] = rng.uniform(0, 1, (R, 3))
    if "flow" in keys:
        for k in ("forward_flow", "backward_flow", "forward_pred_backward_flow",
                  "backward_pred_forward_flow"):
            res[k] = rng.normal(0, 1, (R, S, 3))
        res["agg_mask"] = (rng.uniform(0, 1, (R, S)) < 0.3).astype(np.float32)
    res = {k: np.asarray(v, np.float32) for k, v in res.items()}
    return t[:, :-1].copy(), t[:, 1:].copy(), res


def _check_median(ours, ref, t_starts, t_ends, weights):
    steps = (t_starts + t_ends) / 2.0
    cum = np.cumsum(weights, -1)
    for r in np.nonzero(~np.isclose(ours, ref, rtol=1e-6, atol=1e-5))[0]:
        i_ours = np.argmin(np.abs(steps[r] - ours[r]))
        i_ref = np.argmin(np.abs(steps[r] - ref[r]))
        assert abs(i_ours - i_ref) == 1, (r, i_ours, i_ref)
        assert np.abs(cum[r, min(i_ours, i_ref)] - 0.5) < 1e-5


@pytest.mark.parametrize("decomp", [False, True], ids=["plain", "decomposition"])
@pytest.mark.parametrize("keys", [(), ("shadow", "sky", "flow")], ids=["base", "shadow_sky_flow"])
def test_composite_rays_matches_jax(decomp, keys):
    rng = np.random.default_rng(len(keys) * 2 + decomp)
    ts, te, res = _field_outputs(rng, keys)
    ref = jax_composite(jnp.asarray(ts), jnp.asarray(te),
                        {k: jnp.asarray(v) for k, v in res.items()},
                        return_decomposition=decomp)
    ours = composite_rays(torch.from_numpy(ts), torch.from_numpy(te),
                          {k: torch.from_numpy(v) for k, v in res.items()},
                          return_decomposition=decomp)
    ref_extras, ours_extras = ref.pop("extras"), ours.pop("extras")
    assert set(ours) == set(ref)
    assert set(ours_extras) == set(ref_extras)
    for k in ref:
        a, b = ours[k].numpy(), np.asarray(ref[k])
        assert a.shape == b.shape, k
        if k == "median_depth":
            _check_median(a[:, 0], b[:, 0], ts, te, np.asarray(ref_extras["weights"]))
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ref_extras:
        np.testing.assert_allclose(ours_extras[k].numpy(), np.asarray(ref_extras[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_weights_opacity_depth_matches_jax():
    from emernerf_tpu.render.volrend import weights_opacity_depth_from_density as jax_wod

    rng = np.random.default_rng(5)
    ts, te, res = _field_outputs(rng, ())
    ref = jax_wod(jnp.asarray(ts), jnp.asarray(te), jnp.asarray(res["density"]))
    ours = weights_opacity_depth_from_density(
        torch.from_numpy(ts), torch.from_numpy(te), torch.from_numpy(res["density"]))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_composite_along_rays_checks_inputs():
    ts = torch.zeros(4, 8)
    dens = torch.zeros(4, 8, 2)
    with pytest.raises(ValueError):  # one density set per value channel
        composite_along_rays(ts, ts, dens, torch.zeros(4, 8, 3), [0, 1])
    with pytest.raises(ValueError):  # set index out of range
        composite_along_rays(ts, ts, dens, torch.zeros(4, 8, 1), [2])
    with pytest.raises(ValueError):
        composite_along_rays(ts, ts, torch.zeros(4, 8, 4))
    with pytest.raises(ValueError):
        composite_along_rays(ts.to("meta"), ts.to("meta"), dens.to("meta"))


def _unpack_chan_sets(packed, n_channels):
    """Channel c's set from bits 2(c % 32), 2(c % 32) + 1 of word c // 32,
    as the K3 kernels read them (composite.cu:chan_set)."""
    return tuple((packed[c >> 5] >> (2 * (c & 31))) & 3 for c in range(n_channels))


@pytest.mark.parametrize("n_sets", [1, 2, 3])
def test_packed_chan_sets_round_trip(n_sets):
    """K3 takes the density set of each value channel as 2 bits in eight
    64-bit words: every assignment of up to 3 channels exhaustively, and
    200 random assignments of each count up to 64 and 20 of each count up
    to 256, come back unchanged."""
    assignments = [tuple(int(x) for x in np.unravel_index(i, (n_sets,) * c))
                   for c in range(4) for i in range(n_sets ** c)]
    rng = np.random.default_rng(n_sets)
    assignments += [tuple(int(x) for x in rng.integers(0, n_sets, c))
                    for c in range(65) for _ in range(200)]
    assignments += [tuple(int(x) for x in rng.integers(0, n_sets, c))
                    for c in range(65, 257) for _ in range(20)]
    for sets in assignments:
        words = pack_chan_sets(sets, n_sets)
        assert len(words) == 8 and all(0 <= w < 2 ** 64 for w in words)
        assert _unpack_chan_sets(words, len(sets)) == sets
    assert pack_chan_sets((n_sets - 1,) * 256, n_sets) == (
        (sum((n_sets - 1) << (2 * c) for c in range(32)),) * 8)


@pytest.mark.parametrize("n_sets", [1, 2, 3])
def test_packed_chan_sets_reject_a_set_outside_the_densities(n_sets):
    for bad in ((n_sets,), (0,) * 40 + (n_sets,), (0,) * 200 + (n_sets,), (3,), (-1,),
                (0,) * 257):
        with pytest.raises(ValueError, match="one density set per value channel"):
            pack_chan_sets(bad, n_sets)
    dens = torch.zeros(2, 4, n_sets)
    with pytest.raises(ValueError, match="one density set per value channel"):
        composite_along_rays(dens[..., 0], dens[..., 0], dens, torch.zeros(2, 4, 1), [n_sets])


def test_equal_chan_sets_reuse_the_cached_packing():
    sets = (0, 1, 2, 2, 1, 0, 2)
    packed = pack_chan_sets(sets, 3)
    hits = pack_chan_sets.cache_info().hits
    assert pack_chan_sets(tuple(list(sets)), 3) is packed  # an equal tuple, another object
    assert pack_chan_sets.cache_info().hits == hits + 1
    ts = torch.sort(torch.rand(3, 5), -1)[0]
    hits = pack_chan_sets.cache_info().hits
    composite_along_rays(ts, ts + 0.1, torch.rand(3, 5, 3), torch.rand(3, 5, 7), list(sets))
    assert pack_chan_sets.cache_info().hits == hits + 1


def _tie_ray(equal_midpoints: bool):
    """Two samples whose weights sum to exactly 1.0 in fp32: the opacity
    clip sits on its upper bound.  sigma*dt = 17 then 3, so the remaining
    transmittance exp(-20) ~ 2e-9 is below half an ulp of 1.0."""
    if equal_midpoints:
        ts, te = np.array([[0.0, 0.5]], np.float32), np.array([[2.0, 1.5]], np.float32)
    else:
        ts, te = np.array([[1.0, 3.0]], np.float32), np.array([[3.0, 4.0]], np.float32)
    dens = np.array([[17.0, 3.0]], np.float32) / (te - ts)
    return ts, te, dens


@pytest.mark.parametrize("output", ["opacity", "depth"])
def test_composite_tie_gradient_matches_jax(output):
    """jnp.clip passes half the cotangent at a bound; torch.clamp passes
    all of it.  d(opacity)/d(density) of an opaque ray is halved there, and
    d(depth)/d(density) of a ray whose samples share a midpoint is nonzero
    only through that half."""
    ts, te, dens = _tie_ray(equal_midpoints=output == "depth")

    def jax_out(dn):
        return jax_composite(jnp.asarray(ts), jnp.asarray(te), {"density": dn})[output].sum()

    ref = np.asarray(jax.grad(jax_out)(jnp.asarray(dens)))
    d = torch.from_numpy(dens).requires_grad_(True)
    out = composite_rays(torch.from_numpy(ts), torch.from_numpy(te), {"density": d})
    assert out["opacity"].item() == 1.0  # the tie this test is about
    out[output].sum().backward()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(d.grad.numpy(), ref, rtol=1e-3, atol=0)


def test_sky_loss_tie_gradient_matches_jax():
    """An empty sky ray's opacity is clipped to 1e-6, where the loss clips
    it again at eps = 1e-6: JAX's gradient is half of torch.clamp's."""
    o = np.array([[1e-6], [0.3], [1e-6], [1.0]], np.float32)
    sky = np.array([0.0, 1.0, 1.0, 0.0], np.float32)
    ref = np.asarray(jax.grad(lambda x: jax_sky_loss(x, jnp.asarray(sky), 0.001))(
        jnp.asarray(o)))
    x = torch.from_numpy(o).requires_grad_(True)
    sky_loss_opacity(x, torch.from_numpy(sky), 0.001).backward()
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("pattern", ["trans", "full"])
@pytest.mark.parametrize("s", [63, 64, 65])
def test_composite_backward_matches_jax_vjp(s, pattern):
    """K3 backward's CPU path (the plain version the kernel is held to on
    the card) against jax.vjp of the reference compositing, with the
    training calls' cotangents: the transmittance's alone (the proposal
    levels) or the weights', opacity's, depth's and four value sums' (the
    pixel branch's final composite), at row lengths that are and are not a
    multiple of 4.  d values is exactly zero without a sums cotangent.
    rtol 1e-4 + 1e-5 x the largest |grad| (reverse cumsums in another
    order)."""
    rng = np.random.default_rng(s + (pattern == "full"))
    r = 16
    t = np.sort(rng.uniform(0.5, 80.0, (r, s + 1)).astype(np.float32), -1)
    ts, te = t[:, :-1].copy(), t[:, 1:].copy()
    dens = (rng.uniform(0, 1, (r, s)) ** 3 * 0.5).astype(np.float32)
    vals = rng.uniform(0, 1, (r, s, 4)).astype(np.float32)
    cot = {k: rng.normal(0, 1, shape).astype(np.float32) for k, shape in (
        ("weights", (r, s)), ("trans", (r, s)), ("opacity", (r, 1)), ("depth", (r, 1)),
        ("rgb", (r, 4)))}
    keys = ("trans",) if pattern == "trans" else ("weights", "opacity", "depth", "rgb")

    def jax_out(dn, v):
        out = jax_composite(jnp.asarray(ts), jnp.asarray(te), {"density": dn, "rgb": v})
        every = {"weights": out["extras"]["weights"], "trans": out["extras"]["trans"],
                 "opacity": out["opacity"], "depth": out["depth"], "rgb": out["rgb"]}
        return tuple(every[k] for k in keys)

    _, vjp = jax.vjp(jax_out, jnp.asarray(dens), jnp.asarray(vals))
    ref_dens, ref_vals = (np.asarray(g) for g in vjp(tuple(jnp.asarray(cot[k]) for k in keys)))
    grads = [None if k not in keys else torch.from_numpy(
        cot[k][..., None] if k in ("weights", "trans") else cot[k])
        for k in ("weights", "trans", "opacity", "depth", "rgb")]
    d_dens, d_vals = composite_along_rays_bwd(
        torch.from_numpy(ts), torch.from_numpy(te), torch.from_numpy(dens)[..., None],
        torch.from_numpy(vals), [0] * 4, grads)
    np.testing.assert_allclose(d_dens[..., 0].numpy(), ref_dens, rtol=1e-4,
                               atol=1e-5 * np.abs(ref_dens).max())
    np.testing.assert_allclose(d_vals.numpy(), ref_vals, rtol=1e-4,
                               atol=1e-5 * np.abs(ref_vals).max())
    if pattern == "trans":
        assert not d_vals.any()
