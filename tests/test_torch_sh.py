"""Port parity: the spherical-harmonics direction encoding
(``emernerf_torch/ops/sh.py``) against ``emernerf_tpu/ops/sh.py`` and
against scipy's harmonics (the oracle of ``tests/test_sh.py``), degrees
1-4, fp32, on directions remapped to [0, 1] as the rgb head feeds them and
on raw directions as the sky head feeds them (mapped to 2d - 1, outside
[-1, 1])."""

import numpy as np
import pytest
import torch
from test_sh import _scipy_real_sh

from emernerf_tpu.ops.sh import sh_encode as jax_sh_encode
from emernerf_torch.ops.sh import sh_encode, sh_output_dim


def _dirs(seed, n=256):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
@pytest.mark.parametrize("remap", [True, False], ids=["rgb_head", "sky_head_raw"])
def test_sh_matches_jax(degree, remap):
    d = _dirs(degree).astype(np.float32)
    x = (d + 1.0) / 2.0 if remap else d
    ours = sh_encode(torch.from_numpy(x), degree)
    ref = np.asarray(jax_sh_encode(x, degree))
    assert ours.shape == (len(d), sh_output_dim(degree)) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_matches_scipy(degree):
    d = _dirs(10 + degree)
    x, y, z = d.T
    theta, phi = np.arccos(np.clip(z, -1, 1)), np.arctan2(y, x)
    got = sh_encode(torch.from_numpy((d + 1.0) / 2.0), degree).numpy()
    idx = 0
    for l in range(degree):
        for m in range(-l, l + 1):
            np.testing.assert_allclose(got[:, idx], _scipy_real_sh(l, m, theta, phi),
                                       rtol=1e-10, atol=1e-12, err_msg=f"l={l} m={m}")
            idx += 1


@pytest.mark.parametrize("degree", [0, 5])
def test_sh_invalid_degree_raises(degree):
    with pytest.raises(ValueError, match="degrees 1..4"):
        sh_encode(torch.zeros(4, 3), degree)
