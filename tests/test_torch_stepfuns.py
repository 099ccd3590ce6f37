"""Port parity: emernerf_torch step functions (plain version of kernel K2)
against emernerf_tpu.ops.stepfuns, on the CPU in fp32.  Tolerance: atol 1e-6
(outputs in [0, 1] s-space; the two packages evaluate the same fp32 ops)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emernerf_tpu.ops import stepfuns as jsf
from emernerf_torch.ops import stepfuns as tsf

ATOL = 1e-6


def _cdf_rows(rng, r, k1):
    """Monotone CDFs on k1 edges: normal rows, rows saturating below 1, rows
    with flat runs (ties for searchsorted) and all-zero (zero-opacity) rows."""
    pdf = rng.uniform(0.0, 1.0, (r, k1 - 1)).astype(np.float32)
    pdf[r // 4: r // 2, ::3] = 0.0  # flat runs
    cdf = np.concatenate([np.zeros((r, 1), np.float32), np.cumsum(pdf, -1)], -1)
    cdf /= cdf[:, -1:] + 1e-12
    cdf[r // 2: 3 * r // 4] *= 0.3  # opacity saturating below 1
    cdf[3 * r // 4:] = 0.0  # zero opacity
    s = np.sort(rng.uniform(0.0, 1.0, (r, k1)).astype(np.float32), -1)
    s[:, 0], s[:, -1] = 0.0, 1.0
    return s, cdf.astype(np.float32)


@pytest.mark.parametrize("k1,n", [(2, 128), (129, 64), (65, 64)])
@pytest.mark.parametrize("stratified", [False, True])
def test_importance_sampling_matches_jax(k1, n, stratified):
    rng = np.random.default_rng(k1 * 1000 + n + stratified)
    r = 64
    s, cdf = _cdf_rows(rng, r, k1)
    key = jax.random.PRNGKey(k1 + n)
    ref = np.asarray(jsf.importance_sampling(jnp.asarray(s), jnp.asarray(cdf), n,
                                             stratified, key))
    jitter = None
    if stratified:
        # the draw JAX makes inside importance_sampling, fed to the port
        pad = 1.0 / (2 * (n + 1))
        jitter = torch.from_numpy(np.array(jax.random.uniform(
            key, (r, 1), dtype=jnp.float32, minval=-pad, maxval=pad)))
    ours = tsf.importance_sampling(torch.from_numpy(s), torch.from_numpy(cdf), n, jitter)
    assert ours.shape == ref.shape == (r, n + 1)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=ATOL)
    # zero-opacity rows: 0/0 -> t = 0, so every edge collapses onto s_lo
    assert np.isfinite(ours.numpy()).all()


@pytest.mark.parametrize("n_edges", [2, 5, 9, 17, 65, 129])
def test_sample_positions_bit_equal_to_jnp_linspace(n_edges):
    """Bit-equal wherever XLA's vector loop (8 lanes, with FMA) covers the
    positions, which includes the flagship's 129 and 65; XLA's scalar
    remainder path for fewer than 8 positions rounds some of them 1 ulp
    differently."""
    pad = 1.0 / (2 * n_edges)
    ref = np.asarray(jnp.linspace(pad, 1.0 - pad, n_edges, dtype=jnp.float32))
    ours = tsf.sample_positions(n_edges).numpy()
    if n_edges >= 9:
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_array_max_ulp(ours, ref, maxulp=1)


@pytest.mark.parametrize("kind", sorted(jsf._STOT_FWD))
def test_transform_stot_matches_jax(kind):
    rng = np.random.default_rng(7)
    s = np.concatenate([rng.uniform(0.01, 0.99, 200), [0.0, 0.25, 0.5, 0.75, 1.0]])
    s = s.astype(np.float32)
    near, far = (0.1, 1000.0) if kind != "log" else (0.5, 300.0)
    ref = np.asarray(jsf.transform_stot(kind, jnp.asarray(s), near, far))
    ours = tsf.transform_stot(kind, torch.from_numpy(s), near, far).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=ATOL)


def test_transmittance_matches_jax():
    rng = np.random.default_rng(11)
    t = np.sort(rng.uniform(0.1, 50.0, (32, 65)).astype(np.float32), -1)
    sig = rng.exponential(0.5, (32, 64)).astype(np.float32)
    sig[:4] = 0.0
    ts, te = t[:, :-1], t[:, 1:]
    ref = jsf.render_transmittance_from_density(jnp.asarray(ts), jnp.asarray(te), jnp.asarray(sig))
    ours = tsf.render_transmittance_from_density(
        torch.from_numpy(ts), torch.from_numpy(te), torch.from_numpy(sig))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=ATOL)
    x = rng.normal(size=(5, 9)).astype(np.float32)
    np.testing.assert_allclose(tsf.exclusive_cumsum(torch.from_numpy(x)).numpy(),
                               np.asarray(jsf.exclusive_cumsum(jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("k1,n", [(2, 128), (129, 64), (65, 64)])
def test_cached_sample_positions_bit_equal_and_never_written(k1, n):
    """K2's evenly spaced positions, built once per (count, device), are
    bit-equal to a fresh sample_positions; the sampling reads them and
    never writes them (the tensor's version counter does not move) with
    and without jitter, and every call gets the same tensor."""
    cached = tsf.cached_sample_positions(n + 1, torch.device("cpu"))
    version = cached._version
    assert torch.equal(cached, tsf.sample_positions(n + 1))
    rng = np.random.default_rng(k1 + n)
    s, cdf = (torch.from_numpy(a) for a in _cdf_rows(rng, 16, k1))
    pad = 1.0 / (2 * (n + 1))
    for jitter in (None, torch.full((16, 1), pad), torch.full((16, 1), -pad)):
        out = tsf.importance_sampling(s, cdf, n, jitter)
        assert out.shape == (16, n + 1) and torch.isfinite(out).all()
    assert tsf.cached_sample_positions(n + 1, torch.device("cpu")) is cached
    assert cached._version == version
    assert torch.equal(cached, tsf.sample_positions(n + 1))


def test_importance_sampling_checks_inputs():
    s = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        tsf.importance_sampling(s, torch.zeros(4, 2), 8)
    with pytest.raises(ValueError):
        tsf.importance_sampling(s, s, 8, jitter=torch.zeros(4))
    with pytest.raises(ValueError):
        tsf.importance_sampling(s.to("meta"), s.to("meta"), 8)
