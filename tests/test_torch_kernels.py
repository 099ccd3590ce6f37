"""The port's CUDA kernels: build and binding rules on the CPU, and each
kernel against its plain PyTorch version on the card.

The card tests skip where ``torch.cuda.is_available()`` is false; on a
machine with an H100 run them with
``python -m pytest tests/test_torch_kernels.py``.
"""

import stat

import pytest
import torch

from emernerf_torch import kernels
from emernerf_torch.ops.brickgrid import BrickGridSpec, brickgrid_encode, brickgrid_encode_ref
from emernerf_torch.ops.stepfuns import importance_sampling, importance_sampling_ref
from emernerf_torch.render.volrend import composite_along_rays, composite_along_rays_ref


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """An empty build directory and no library loaded yet."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels._State, "lib", None)
    return tmp_path


def test_missing_nvcc_raises(fresh_build, monkeypatch):
    monkeypatch.setattr(kernels, "nvcc_path", lambda: str(fresh_build / "no-such-nvcc"))
    with pytest.raises(kernels.KernelBuildError, match="nvcc not found"):
        kernels.load()
    assert kernels._State.lib is None


def test_failed_compile_raises_and_leaves_no_library(fresh_build, monkeypatch):
    fake = fresh_build / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(kernels, "nvcc_path", lambda: str(fake))
    with pytest.raises(kernels.KernelBuildError, match="refused"):
        kernels.load()
    assert not (kernels.BUILD_DIR / kernels.LIB_NAME).exists()


def test_launch_error_raises():
    kernels.check(0, "ok")
    with pytest.raises(kernels.KernelLaunchError):
        kernels.check(700, "brickgrid_encode")


def test_sources_name_the_tpu_op_they_replace():
    for src in sorted(kernels.CSRC.glob("*.cu")):
        head = src.read_text()[:1500]
        assert "Replaces: emernerf_tpu/" in head and "bounds it on the H100" in head, src


# ---------------------------------------------------------------- card only
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load()
    return torch.device("cuda")


@pytest.mark.parametrize("dims,f,bs,pair", [(3, 4, 1, False), (3, 1, 2, False),
                                            (4, 8, 1, True), (4, 2, 1, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_brickgrid_kernel_matches_plain(cuda, dims, f, bs, pair, dtype):
    spec = BrickGridSpec(n_input_dims=dims, n_levels=6, base_resolution=8,
                         max_resolution=512, log2_bricks=14 - 3 * bs,
                         n_features_per_level=f, log2_brick_size=bs, time_pair=pair)
    g = torch.Generator(device=cuda).manual_seed(0)
    table = torch.rand(spec.table_shape, device=cuda, generator=g).to(dtype)
    pos = torch.rand((4096, dims), device=cuda, generator=g)
    with torch.no_grad():
        out = brickgrid_encode(table, pos, spec)
        ref = brickgrid_encode_ref(table, pos, spec)
    torch.cuda.synchronize()
    # same explicitly rounded fp32 ops in the same order; bf16 rounds once
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=1e-6)


def test_importance_sampling_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    r, k1, n = 1024, 65, 64
    s = torch.sort(torch.rand((r, k1), device=cuda, generator=g), -1)[0]
    cdf = torch.cumsum(torch.rand((r, k1), device=cuda, generator=g), -1)
    cdf[:16] = 0.0
    jitter = (torch.rand((r, 1), device=cuda, generator=g) - 0.5) / (n + 1)
    for jit in (None, jitter):
        out = importance_sampling(s, cdf, n, jit)
        ref = importance_sampling_ref(s, cdf, n, jit)
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


def test_composite_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    r, s = 2048, 64
    t = torch.sort(torch.rand((r, s + 1), device=cuda, generator=g) * 50, -1)[0]
    ts, te = t[:, :-1].contiguous(), t[:, 1:].contiguous()
    dens = torch.rand((r, s, 3), device=cuda, generator=g) * 0.2
    vals = torch.rand((r, s, 7), device=cuda, generator=g)
    sets = [0, 0, 0, 1, 1, 2, 2]
    out = composite_along_rays(ts, te, dens, vals, sets)
    ref = composite_along_rays_ref(ts, te, dens, vals, sets)
    for name, a, b in zip(out._fields, out, ref):
        if name != "median_depth":
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)
    assert (out.median_depth != ref.median_depth).float().mean() < 0.01
