"""The port's CUDA kernels: build and binding rules on the CPU, and each
kernel against its plain PyTorch version on the card.

The card tests carry the ``cuda`` marker and skip where
``torch.cuda.is_available()`` is false; on a machine with an H100 run them
with ``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``
(the test configuration imports JAX, which the port's machines need not
have).
"""

import dataclasses
import os
import stat

import numpy as np
import pytest
import torch

from emernerf_torch import kernels
from emernerf_torch.ops import gather_scatter as gs
from emernerf_torch.ops.brickgrid import (
    BrickGridSpec,
    brickgrid_encode,
    brickgrid_encode_bwd,
    brickgrid_encode_bwd_ref,
    brickgrid_encode_ref,
)
from emernerf_torch.ops.hashgrid import (
    HashGridSpec,
    features_minor,
    features_minor_plain,
    hashgrid_encode,
    hashgrid_encode_bwd,
    hashgrid_encode_bwd_plain,
    hashgrid_encode_plain,
)
from emernerf_torch.ops.mxgrid import (
    MXGridSpec,
    init_mxgrid_table,
    mx_lines_encode,
    mx_lines_encode_bwd,
    mx_lines_encode_bwd_ref,
    mx_lines_encode_ref,
)
from emernerf_torch.ops.stepfuns import (
    _interlevel_forward,
    cached_sample_positions,
    importance_sampling,
    importance_sampling_ref,
    interlevel_loss_bwd,
    interlevel_loss_bwd_ref,
    interlevel_loss_levels,
    interlevel_loss_levels_bwd,
    interlevel_loss_levels_bwd_ref,
    interlevel_loss_levels_ref,
    interlevel_loss_ref,
)
from emernerf_torch.render.volrend import (
    composite_along_rays,
    composite_along_rays_bwd,
    composite_along_rays_bwd_ref,
    composite_along_rays_ref,
)
from emernerf_torch.train.optim import (
    adam_update,
    adam_update_ref,
    apply_direction,
    apply_direction_ref,
    make_adam,
    SPMD_LEAVES_PER_LAUNCH,
    spmd_adam_update,
    spmd_adam_update_ref,
    vector_width,
    zero_slab_update,
    zero_slab_update_ref,
)


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


def test_stale_library_is_rebuilt(fresh_build, monkeypatch):
    """A library older than any source or header (one built before a source
    changed or was added) is rebuilt; one newer than every source is
    reused.  nvcc never runs: a missing nvcc shows that a rebuild was
    attempted."""
    csrc = fresh_build / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text("// source\n")
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "nvcc_path", lambda: str(fresh_build / "no-such-nvcc"))
    lib = kernels.BUILD_DIR / kernels.LIB_NAME
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    os.utime(csrc / "a.cu", (1000, 1000))
    os.utime(csrc / "b.cu", (1000, 1000))
    os.utime(lib, (2000, 2000))
    assert kernels.build() == lib  # newer than every source: reused
    os.utime(csrc / "b.cu", (3000, 3000))  # a source changed after the build
    with pytest.raises(kernels.KernelBuildError, match="nvcc not found"):
        kernels.build()
    (csrc / "c.cu").write_text("// a source added after the build\n")
    os.utime(csrc / "b.cu", (1000, 1000))
    os.utime(csrc / "c.cu", (2500, 2500))
    with pytest.raises(kernels.KernelBuildError, match="nvcc not found"):
        kernels.load()
    assert kernels._State.lib is None
    os.utime(csrc / "c.cu", (1000, 1000))
    (csrc / "shared.cuh").write_text("// a header the sources include\n")
    os.utime(csrc / "shared.cuh", (3000, 3000))  # changed after the build
    with pytest.raises(kernels.KernelBuildError, match="nvcc not found"):
        kernels.build()


def test_sources_name_the_tpu_op_they_replace():
    for src in sorted(kernels.CSRC.glob("*.cu")):
        head = src.read_text()[:1500]
        # a JAX package op, or one of the TPU probes under perf/
        assert ("Replaces: emernerf_tpu/" in head or "Replaces: perf/" in head), src
        assert "bounds it on the H100" in head, src


# ---------------------------------------------------------------- card only
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load()
    return torch.device("cuda")


@pytest.mark.cuda
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


def _check_composite_forward(out, ref, t_starts, t_ends):
    """The kernel against the plain version: rtol 1e-5 (depth 1e-4, a
    division by the opacity), atol 1e-5 (sums of S weighted fp32 terms in
    another order); a median depth may move by one sample only where the
    plain cumsum of the weights lies within 1e-5 of 0.5."""
    for name, a, b in zip(out._fields, out, ref):
        assert a.shape == b.shape, name
        if name == "median_depth":
            moved = (a != b).squeeze(-1)
            if moved.any():
                cum = torch.cumsum(ref.weights[..., 0], -1)[moved]
                assert float((cum - 0.5).abs().min(-1)[0].max()) <= 1e-5
            continue
        torch.testing.assert_close(a, b, rtol=1e-4 if name == "depth" else 1e-5, atol=1e-5,
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [0, 1, 4, 23, 64])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("s", [1, 31, 32, 33, 64, 128, 256])
def test_composite_forward_kernel_shapes_match_plain(cuda, s, d, c):
    """K3 forward at every sample count class (one, two, four and eight
    samples per lane, ragged lanes), density set count and value width up
    to 64 channels, over 9,001 rays (no multiple of the rays per stage,
    several stages per persistent block); two runs bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(31 + s + 7 * d + 13 * c)
    r = 9001
    t = torch.sort(torch.rand((r, s + 1), device=cuda, generator=g) * 50, -1)[0] + 0.1
    ts, te = t[:, :-1].contiguous(), t[:, 1:].contiguous()
    dens = torch.rand((r, s, d), device=cuda, generator=g) ** 3 * 0.2
    dens[:7] = 0.0  # empty rays: opacity clipped to 1e-6
    vals = torch.rand((r, s, c), device=cuda, generator=g) if c else None
    sets = [int(x) for x in torch.randint(0, d, (c,), generator=torch.Generator().manual_seed(c))]
    before = composite_along_rays.launches
    out = composite_along_rays(ts, te, dens, vals, sets)
    again = composite_along_rays(ts, te, dens, vals, sets)
    assert composite_along_rays.launches == before + 2
    ref = composite_along_rays_ref(ts, te, dens, vals, sets)
    torch.cuda.synchronize()
    _check_composite_forward(out, ref, ts, te)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def _brick_spec(dims, f, bs, pair):
    return BrickGridSpec(n_input_dims=dims, n_levels=6, base_resolution=8,
                         max_resolution=512, log2_bricks=14 - 3 * bs,
                         n_features_per_level=f, log2_brick_size=bs, time_pair=pair)


def _check_brick_backward(spec, table, pos, cot, pos_grad=True):
    """The kernel against the plain version: the table gradient within one
    rounding (fp32 atomics and warp merges in another order than
    index_add_; bf16 grads round once); the position gradient bit for bit
    (the same fp32 operations in the same order, levels summed in order, no
    atomics) and equal between two runs."""
    d_t, d_x = brickgrid_encode_bwd(table, pos, cot, spec, pos_grad)
    again = brickgrid_encode_bwd(table, pos, cot, spec, pos_grad)[1]
    r_t, r_x = brickgrid_encode_bwd_ref(table, pos, cot, spec, pos_grad)
    torch.cuda.synchronize()
    rtol = 1e-5 if table.dtype == torch.float32 else 2 ** -7
    assert d_t.dtype == table.dtype and d_t.shape == r_t.shape
    torch.testing.assert_close(d_t.float(), r_t.float(), rtol=rtol,
                               atol=1e-5 * float(r_t.float().abs().max()))
    if pos_grad:
        assert torch.equal(d_x, r_x) and torch.equal(d_x, again)
    else:
        assert d_x is None and r_x is None


# (dims, F, log2_brick_size, time_pair): the proposal grids' F = 1 in 4^3
# cells (odd 125-wide rows), the static F = 4, the fused grid's time-paired
# F = 8 and unpaired 4D rows
_BRICK_LAYOUTS = [(3, 1, 2, False), (3, 4, 1, False), (4, 8, 1, True), (4, 2, 1, False),
                  (4, 4, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dims,f,bs,pair", _BRICK_LAYOUTS[:4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_brickgrid_backward_kernel_matches_plain(cuda, dims, f, bs, pair, dtype):
    spec = _brick_spec(dims, f, bs, pair)
    g = torch.Generator(device=cuda).manual_seed(4)
    table = torch.rand(spec.table_shape, device=cuda, generator=g).to(dtype)
    pos = torch.rand((4096, dims), device=cuda, generator=g)
    cot = torch.randn((4096, spec.n_output_dims), device=cuda, generator=g).to(dtype)
    _check_brick_backward(spec, table, pos, cot)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_cell", "equal_rows_per_warp", "n_not_multiple_of_32"])
@pytest.mark.parametrize("dims,f,bs,pair", [_BRICK_LAYOUTS[i] for i in (0, 1, 2, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_brickgrid_backward_kernel_worst_contention(cuda, case, dims, f, bs, pair, dtype):
    """Every point in one coarse cell (every lane of every warp on the same
    slots of the coarse levels); each warp's 32 points equal (one run of 32
    on every level); and 1,000 points (a last warp of 8 live lanes)."""
    spec = _brick_spec(dims, f, bs, pair)
    g = torch.Generator(device=cuda).manual_seed(16)
    table = (torch.rand(spec.table_shape, device=cuda, generator=g) * 2 - 1).to(dtype)
    pos = torch.rand((4096, dims), device=cuda, generator=g)
    if case == "one_cell":
        pos = 0.5 + 0.01 * pos
    elif case == "equal_rows_per_warp":
        pos = pos[::32].repeat_interleave(32, 0).contiguous()
    else:
        pos = pos[:1000].contiguous()
    cot = torch.randn((pos.shape[0], spec.n_output_dims), device=cuda, generator=g).to(dtype)
    for pos_grad in (False, True):
        _check_brick_backward(spec, table, pos, cot, pos_grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,f,bs,pair", _BRICK_LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_brickgrid_backward_kernel_on_ray_ordered_points(cuda, dims, f, bs, pair, dtype):
    """Ray-major samples, as training's top-K samples come: neighbouring
    lanes share slots on the coarse levels, so the warp merges runs."""
    spec = _brick_spec(dims, f, bs, pair)
    g = torch.Generator(device=cuda).manual_seed(17)
    table = (torch.rand(spec.table_shape, device=cuda, generator=g) * 2 - 1).to(dtype)
    pos = _ray_positions(cuda, g, 96, 32, dims)
    cot = torch.randn((pos.shape[0], spec.n_output_dims), device=cuda, generator=g).to(dtype)
    _check_brick_backward(spec, table, pos, cot)


# K1's (storage, compute) dtype pairs: the fp32 parameter with an fp32 or a
# bf16 computation (the flagship's), and a bf16 table
_K1_TYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16)]
_K1_TYPE_IDS = ["fp32", "fp32_stored_bf16_compute", "bf16"]


def _cell_boundary_points(cuda, spec, seed):
    """Points on cell and brick boundaries of every level, nudged by -1, 0
    and +1 ulp, where a differently rounded x * scale + 0.5 picks another
    cell (and, across a brick boundary, another row)."""
    rng = np.random.default_rng(seed)
    d, pts = spec.n_input_dims, []
    for sc in np.asarray(spec.level_scales, np.float32):
        cells = rng.integers(1, int(sc) + 1, size=(64, d))
        cells[:32] = (cells[:32] // (2 * spec.brick_cells)) * 2 * spec.brick_cells \
            + spec.brick_cells
        x = ((cells - 0.5) / sc).astype(np.float32)
        for nudge in (-1, 0, 1):
            xn = np.nextafter(x, np.float32(nudge * np.inf)) if nudge else x
            pts.append(np.clip(xn, 0.0, 1.0).astype(np.float32))
    return torch.from_numpy(np.concatenate(pts)).to(cuda)


def _k1_points(cuda, g, spec, case):
    dims = spec.n_input_dims
    pos = torch.rand((4096, dims), device=cuda, generator=g)
    if case == "rays":
        return _ray_positions(cuda, g, 128, 32, dims)
    if case == "one_cell":
        return 0.5 + 0.01 * pos
    if case == "cell_boundaries":
        return _cell_boundary_points(cuda, spec, 21)
    if case == "n_not_multiple_of_32":
        return pos[:1000].contiguous()
    return pos


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "rays", "one_cell", "cell_boundaries",
                                  "n_not_multiple_of_32"])
@pytest.mark.parametrize("dims,f,bs,pair", _BRICK_LAYOUTS)
@pytest.mark.parametrize("stored,compute", _K1_TYPES, ids=_K1_TYPE_IDS)
def test_brickgrid_kernel_matches_plain(cuda, case, dims, f, bs, pair, stored, compute):
    """K1 forward against the plain version bit for bit (the same
    explicitly rounded fp32 operations in the same corner order, one
    rounding to the compute dtype), on uniform, ray-ordered and
    worst-contention points (all in one coarse cell: every lane on the same
    slots), on cell boundaries +-1 ulp, and on 1,000 points (the last
    block's tile holds 8 rows).  An fp32 table with a bf16 computation also
    equals the kernel on the table's bf16 cast."""
    spec = _brick_spec(dims, f, bs, pair)
    g = torch.Generator(device=cuda).manual_seed(20)
    table = (torch.rand(spec.table_shape, device=cuda, generator=g) * 2 - 1).to(stored)
    pos = _k1_points(cuda, g, spec, case)
    before = brickgrid_encode.launches
    with torch.no_grad():
        out = brickgrid_encode(table, pos, spec, compute)
        ref = brickgrid_encode_ref(table, pos, spec, compute)
    torch.cuda.synchronize()
    assert brickgrid_encode.launches == before + 1
    assert out.dtype == compute and torch.equal(out, ref)
    if stored != compute:
        with torch.no_grad():
            assert torch.equal(out, brickgrid_encode(table.to(compute), pos, spec))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "rays", "one_cell", "cell_boundaries"])
@pytest.mark.parametrize("dims,f,bs,pair", _BRICK_LAYOUTS)
def test_brickgrid_backward_kernel_fp32_table_bf16_compute(cuda, case, dims, f, bs, pair):
    """K1 backward on the fp32 table of a bf16 computation: the position
    gradient re-reads the table rounded to bf16 in registers, bit for bit
    with the plain version (which casts first), with a second run and with
    the kernel on the table's bf16 cast; the table gradient comes back fp32
    and already rounded to bf16 precision, within one bf16 rounding of the
    plain version (atomics in another order)."""
    spec = _brick_spec(dims, f, bs, pair)
    g = torch.Generator(device=cuda).manual_seed(22)
    table = torch.rand(spec.table_shape, device=cuda, generator=g) * 2 - 1
    pos = _k1_points(cuda, g, spec, case)
    cot = torch.randn((pos.shape[0], spec.n_output_dims), device=cuda,
                      generator=g).bfloat16()
    d_t, d_x = brickgrid_encode_bwd(table, pos, cot, spec, True, torch.bfloat16)
    again = brickgrid_encode_bwd(table, pos, cot, spec, True, torch.bfloat16)[1]
    cast_t, cast_x = brickgrid_encode_bwd(table.bfloat16(), pos, cot, spec, True)
    r_t, r_x = brickgrid_encode_bwd_ref(table, pos, cot, spec, True, torch.bfloat16)
    torch.cuda.synchronize()
    assert d_t.dtype == torch.float32 and torch.equal(d_t, d_t.bfloat16().float())
    assert torch.equal(d_x, r_x) and torch.equal(d_x, again) and torch.equal(d_x, cast_x)
    for want in (r_t, cast_t.float()):
        torch.testing.assert_close(d_t, want, rtol=2 ** -7,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,f,bs,pair", [_BRICK_LAYOUTS[i] for i in (0, 1, 2)])
def test_brickgrid_autograd_fp32_table_bf16_compute_on_the_card(cuda, dims, f, bs, pair):
    """brickgrid_encode on the fp32 parameter with a bf16 computation:
    one forward and one backward launch, no bf16 tensor saved for the
    backward, the encoding and the position gradient bit for bit with the
    plain versions, the table gradient fp32 at bf16 precision."""
    spec = _brick_spec(dims, f, bs, pair)
    g = torch.Generator(device=cuda).manual_seed(23)
    table = torch.rand(spec.table_shape, device=cuda, generator=g) * 2 - 1
    pos = torch.rand((4096, dims), device=cuda, generator=g)
    cot = torch.randn((4096, spec.n_output_dims), device=cuda, generator=g).bfloat16()
    t = table.clone().requires_grad_(True)
    x = pos.clone().requires_grad_(True)
    before = (brickgrid_encode.launches, brickgrid_encode_bwd.launches)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda v: saved.append(v) or v,
                                                  lambda v: v):
        out = brickgrid_encode(t, x, spec, torch.bfloat16)
    out.backward(cot)
    torch.cuda.synchronize()
    assert (brickgrid_encode.launches, brickgrid_encode_bwd.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    assert all(v.dtype == torch.float32 for v in saved) and len(saved) == 2
    assert torch.equal(out.detach(), brickgrid_encode_ref(table, pos, spec, torch.bfloat16))
    r_t, r_x = brickgrid_encode_bwd_ref(table, pos, cot, spec, True, torch.bfloat16)
    assert torch.equal(x.grad, r_x)
    assert t.grad.dtype == torch.float32 and torch.equal(t.grad, t.grad.bfloat16().float())
    torch.testing.assert_close(t.grad, r_t, rtol=2 ** -7, atol=1e-5 * float(r_t.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,f,bs,pair", [_BRICK_LAYOUTS[i] for i in (0, 1, 2)])
@pytest.mark.parametrize("k", [1, 4], ids=["view", "view_subsample4"])
def test_brickgrid_coarse_view_and_subsample_on_the_card(cuda, dims, f, bs, pair, k):
    """K1 on a coarse view (4 of 6 levels, the table's first rows) and with
    ``grad_subsample`` k: the forward bit for bit with the plain version
    and with the full encode's first levels, the backward as
    _check_brick_backward (the position gradient bit for bit, and equal to
    the unsubsampled one)."""
    full = _brick_spec(dims, f, bs, pair)
    spec = dataclasses.replace(full, view_levels=4, grad_subsample=k)
    assert spec.level_uses_hash[:4].any()  # a hashed level takes the stride
    g = torch.Generator(device=cuda).manual_seed(24)
    table = torch.rand(full.table_shape, device=cuda, generator=g) * 2 - 1
    view = table[:spec.table_shape[0]]
    pos = torch.rand((4096, dims), device=cuda, generator=g)
    cot = torch.randn((4096, spec.n_output_dims), device=cuda, generator=g)
    with torch.no_grad():
        out = brickgrid_encode(view, pos, spec)
        assert torch.equal(out, brickgrid_encode_ref(view, pos, spec))
        assert torch.equal(out, brickgrid_encode(table, pos, full)[:, :spec.n_output_dims])
    _check_brick_backward(spec, view, pos, cot)
    plain = dataclasses.replace(spec, grad_subsample=1)
    assert torch.equal(brickgrid_encode_bwd(view, pos, cot, spec, True)[1],
                       brickgrid_encode_bwd(view, pos, cot, plain, True)[1])


# the MX grids of the full-width flagship: (dims, F, rank, scales);
# static, fused dynamic+flow, proposal; and the tiny fused grid's W = 96
_MX_GRIDS = {"static": (3, 4, 16, 10), "fused": (4, 8, 16, 10), "prop": (3, 1, 16, 8),
             "tiny_fused": (4, 6, 16, 4)}
# the points K12 is held on: uniform with knots; ray-ordered samples of short
# segments (long runs on one row of every line); every point equal (one run
# across every chunk of the backward); a few points, each repeated for a
# run longer than a chunk; points outside the box on both sides
_MX_POINTS = ("uniform", "rays", "equal", "runs", "outside")
_MX_N = 5600
# every stored / compute pair: bf16 lines with an fp32 computation too
_MX_TYPES = _K1_TYPES + [(torch.bfloat16, torch.float32)]
_MX_TYPE_IDS = _K1_TYPE_IDS + ["bf16_stored_fp32_compute"]


def _mx_points(cuda, g, dims, kind):
    if kind == "uniform":
        vals = torch.tensor([0.0, 1.0, 0.5, 0.25, 1 - 2 ** -24, 7 / 128], device=cuda)
        knots = vals[torch.randint(0, 6, (600, dims), device=cuda, generator=g)]
        return torch.cat([torch.rand((_MX_N - 600, dims), device=cuda, generator=g), knots])
    if kind == "rays":  # 128 samples over 0.1 of the box a ray, each ray at its own time
        start = torch.rand((_MX_N // 128, 1, dims), device=cuda, generator=g) * 0.9
        step = torch.rand((_MX_N // 128, 1, dims), device=cuda, generator=g) * 0.1
        if dims == 4:
            step[..., 3] = 0.0
        s = torch.linspace(0.0, 1.0, 128, device=cuda)[None, :, None]
        return (start + s * step).reshape(-1, dims).contiguous()
    if kind == "equal":
        return torch.rand((1, dims), device=cuda, generator=g).expand(_MX_N, dims).contiguous()
    if kind == "runs":
        pts = torch.rand((7, dims), device=cuda, generator=g)
        return pts.repeat_interleave(_MX_N // 7, 0).contiguous()
    return torch.rand((_MX_N, dims), device=cuda, generator=g) * 2 - 0.5


def _mx_case(cuda, name, seed, points="uniform"):
    dims, f, rank, levels = _MX_GRIDS[name]
    spec = MXGridSpec(n_input_dims=dims, n_levels=levels, base_resolution=16,
                      max_resolution=8192, n_features_per_level=f, rank=rank)
    g = torch.Generator(device=cuda).manual_seed(seed)
    table = init_mxgrid_table(spec, device=cuda, generator=g) * 3
    lines = table[spec.part_sizes[0]:spec.num_parameters]
    pos = _mx_points(cuda, g, dims, points)
    cot = torch.randn((pos.shape[0], spec.n_scales * f), device=cuda, generator=g)
    return spec, lines, pos, cot


@pytest.mark.cuda
@pytest.mark.parametrize("points", _MX_POINTS)
@pytest.mark.parametrize("name", sorted(_MX_GRIDS))
@pytest.mark.parametrize("stored,compute", _MX_TYPES, ids=_MX_TYPE_IDS)
def test_mxgrid_kernels_match_plain(cuda, name, stored, compute, points):
    """K12 forward bit for bit with the plain version (the same rounded
    operations, ranks added in order); the backward's line gradient within
    rtol 1e-5 + 1e-5 x its largest |grad| (fp32 sums in another order; for
    a bf16 computation or bf16 lines one bf16 rounding, rtol 2^-7), the
    position gradient within 1e-5 x its largest |grad| (the lanes' sums in
    another order), on every pattern of points in _MX_POINTS, with and
    without the position gradient."""
    spec, lines, pos, cot = _mx_case(cuda, name, 25, points)
    lines = lines.to(stored)
    before = (mx_lines_encode.launches, mx_lines_encode_bwd.launches)
    out = mx_lines_encode(lines, pos, spec, compute)
    d_l, d_x = mx_lines_encode_bwd(lines, pos, cot, spec, True, compute)
    r_l, r_x = mx_lines_encode_bwd_ref(lines, pos, cot, spec, True, compute)
    torch.cuda.synchronize()
    assert (mx_lines_encode.launches, mx_lines_encode_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    assert out.dtype == torch.float32 and torch.equal(out, mx_lines_encode_ref(lines, pos, spec,
                                                                               compute))
    assert d_l.dtype == stored
    # one bf16 rounding where the gradient is computed or returned in bf16
    rtol = 1e-5 if torch.bfloat16 not in (stored, compute) else 2 ** -7
    torch.testing.assert_close(d_l.float(), r_l.float(), rtol=rtol,
                               atol=1e-5 * float(r_l.float().abs().max()))
    torch.testing.assert_close(d_x, r_x, rtol=0, atol=1e-5 * float(r_x.abs().max()))
    if points == "uniform":
        assert float(r_x.abs().max()) > 1.0
    # the line gradient alone, without the position gradient's pass
    d_l2, none = mx_lines_encode_bwd(lines, pos, cot, spec, False, compute)
    assert none is None
    torch.testing.assert_close(d_l2.float(), r_l.float(), rtol=rtol,
                               atol=1e-5 * float(r_l.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_MX_GRIDS))
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_mxgrid_position_gradient_is_bit_for_bit_between_runs(cuda, name, compute):
    """K12's position gradient is summed in a fixed order (per point, scale
    and slot by shuffles, then over the scales and slots), so two runs on
    the same inputs agree bit for bit, on ray-ordered and uniform points."""
    for points in ("rays", "uniform"):
        spec, lines, pos, cot = _mx_case(cuda, name, 26, points)
        first = mx_lines_encode_bwd(lines, pos, cot, spec, True, compute)[1]
        second = mx_lines_encode_bwd(lines, pos, cot, spec, True, compute)[1]
        assert torch.equal(first, second), points


def _sampling_rows(cuda, g, r, k1):
    """Sorted edges and monotone CDFs: normal rows, rows with flat runs
    (ties for the search), rows saturating below 1, zero-opacity rows and
    flat rows (every CDF value equal)."""
    s = torch.sort(torch.rand((r, k1), device=cuda, generator=g), -1)[0]
    pdf = torch.rand((r, k1), device=cuda, generator=g) ** 4
    pdf[:, 0] = 0.0
    pdf[r // 5: 2 * r // 5, ::3] = 0.0
    cdf = torch.cumsum(pdf, -1)
    cdf = cdf / cdf[:, -1:]
    cdf[2 * r // 5: 3 * r // 5] *= 0.3
    cdf[3 * r // 5: 4 * r // 5] = 0.0
    cdf[4 * r // 5:] = 0.7
    return s.contiguous(), cdf.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("k1,n", [(2, 128), (129, 64), (65, 64)])
@pytest.mark.parametrize("r", [16384, 8195], ids=["eval_chunk", "train_branch_plus_3"])
@pytest.mark.parametrize("jitter", ["none", "plus_pad", "minus_pad", "random"])
def test_importance_sampling_kernel_matches_plain(cuda, k1, n, r, jitter):
    """K2 at the three sampling steps of an eval chunk (16,384 rays) and of
    a training branch (8,192 rays; 8,195 leaves the last block 3 rays),
    with zero, flat and saturating CDFs and the jitter at +-pad: within
    atol 1e-6 of the plain version (rtol 0).  The cached positions are
    never written."""
    g = torch.Generator(device=cuda).manual_seed(24)
    s, cdf = _sampling_rows(cuda, g, r, k1)
    pad = 1.0 / (2 * (n + 1))
    jit = {"none": None, "plus_pad": torch.full((r, 1), pad, device=cuda),
           "minus_pad": torch.full((r, 1), -pad, device=cuda),
           "random": (torch.rand((r, 1), device=cuda, generator=g) * 2 - 1) * pad}[jitter]
    u = cached_sample_positions(n + 1, s.device)
    version = u._version
    before = importance_sampling.launches
    out = importance_sampling(s, cdf, n, jit)
    ref = importance_sampling_ref(s, cdf, n, jit)
    torch.cuda.synchronize()
    assert importance_sampling.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
    assert u._version == version and cached_sample_positions(n + 1, s.device) is u


@pytest.mark.cuda
def test_importance_sampling_refuses_rows_beyond_shared_memory(cuda):
    s = torch.zeros((4, 769), device=cuda)
    with pytest.raises(ValueError, match="input edges"):
        importance_sampling(s, s, 8)


@pytest.mark.cuda
def test_composite_backward_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    r, s = 2048, 64
    t = torch.sort(torch.rand((r, s + 1), device=cuda, generator=g) * 50, -1)[0]
    ts, te = t[:, :-1].contiguous(), t[:, 1:].contiguous()
    dens = torch.rand((r, s, 3), device=cuda, generator=g) * 0.2
    vals = torch.rand((r, s, 7), device=cuda, generator=g)
    sets = [0, 0, 0, 1, 1, 2, 2]
    rnd = lambda *shape: torch.randn(shape, device=cuda, generator=g)  # noqa: E731
    for grads in ((rnd(r, s, 3), rnd(r, s, 3), rnd(r, 3), rnd(r, 3), rnd(r, 7)),
                  (None, rnd(r, s, 3), None, None, None)):
        out = composite_along_rays_bwd(ts, te, dens, vals, sets, grads)
        ref = composite_along_rays_bwd_ref(ts, te, dens, vals, sets, grads)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))


@pytest.mark.cuda
def test_composite_backward_kernel_tie_gradient(cuda):
    """Two rays whose weights sum to exactly 1.0 (sigma*dt = 17 then 3): the
    opacity clip sits on its bound and passes half its gradient, in the
    kernel as in the plain version (tests/test_torch_volrend.py pins the
    plain version against jax.grad)."""
    ts = torch.tensor([[1.0, 3.0], [0.0, 0.5]], device=cuda)
    te = torch.tensor([[3.0, 4.0], [2.0, 1.5]], device=cuda)
    dens = (torch.tensor([[17.0, 3.0], [17.0, 3.0]], device=cuda) / (te - ts))[..., None]
    grads = (None, None, torch.ones((2, 1), device=cuda), torch.ones((2, 1), device=cuda), None)
    out = composite_along_rays(ts, te, dens.contiguous())
    assert torch.equal(out.opacity, torch.ones_like(out.opacity))
    d, _ = composite_along_rays_bwd(ts, te, dens.contiguous(), None, [], grads)
    ref, _ = composite_along_rays_bwd_ref(ts, te, dens.contiguous(), None, [], grads)
    torch.testing.assert_close(d, ref, rtol=1e-3, atol=0)


def _composite_bwd_case(dev, seed, r, s, d, c, pattern):
    """Seeded K3 backward inputs: edges, densities, values and channel sets,
    and the cotangents of the pattern: 'trans' (the proposal levels),
    'full' (every output) or 'no_sums' (every output but the sums)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.sort(torch.rand((r, s + 1), device=dev, generator=g) * 50, -1)[0] + 0.1
    ts, te = t[:, :-1].contiguous(), t[:, 1:].contiguous()
    dens = torch.rand((r, s, d), device=dev, generator=g) ** 3 * 0.5
    vals = torch.rand((r, s, c), device=dev, generator=g) if c else None
    sets = [j % d for j in range(c)]
    rnd = lambda *shape: torch.randn(shape, device=dev, generator=g)  # noqa: E731
    if pattern == "trans":
        grads = (None, rnd(r, s, d), None, None, None)
    else:
        grads = (rnd(r, s, d), rnd(r, s, d), rnd(r, d), rnd(r, d),
                 rnd(r, c) if c and pattern == "full" else None)
    return ts, te, dens, vals, sets, grads


def _check_composite_bwd(out, ref):
    for a, b in zip(out, ref):
        if b is None:
            assert a is None
            continue
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [0, 4, 7])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 128, 256])
def test_composite_backward_kernel_shapes_match_plain(cuda, s, d, c):
    """K3 backward at rows that are (S a multiple of 4, D = 1: vector loads)
    and are not 16-byte aligned, at one, two, four and eight samples per
    lane, with the transmittance's cotangent alone (the trans-only kernel),
    every cotangent, and every one but the sums' (d values then exactly
    zero), over 2,053 rays; rtol 1e-4 + 1e-5 x max |grad| against the
    plain version, and two runs bit for bit."""
    for k, pattern in enumerate(("trans", "full", "no_sums")):
        ts, te, dens, vals, sets, grads = _composite_bwd_case(cuda, 100 + s + 7 * d + 13 * c + k,
                                                              2053, s, d, c, pattern)
        before = composite_along_rays_bwd.launches
        out = composite_along_rays_bwd(ts, te, dens, vals, sets, grads)
        assert composite_along_rays_bwd.launches == before + 1
        _check_composite_bwd(out, composite_along_rays_bwd_ref(ts, te, dens, vals, sets, grads))
        again = composite_along_rays_bwd(ts, te, dens, vals, sets, grads)
        assert all(a is None or torch.equal(a, b) for a, b in zip(out, again))
        if vals is not None and grads[4] is None:
            assert not out[1].any()  # no sums cotangent: d values exactly zero


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["t_starts", "densities", "g_trans", "values"])
def test_composite_backward_kernel_on_misaligned_pointers(cuda, what):
    """A contiguous input that starts 4 bytes past a 16-byte boundary (a
    view one float into its storage) takes the scalar loads, at the
    pixel branch's shape class (S = 64, D = 1, C = 4) and the proposal
    levels' (trans only)."""
    for pattern in ("full", "trans"):
        ts, te, dens, vals, sets, grads = _composite_bwd_case(cuda, 7, 1029, 64, 1, 4, pattern)

        def shifted(x):
            buf = torch.empty(x.numel() + 1, device=cuda)
            view = buf[1:].view(x.shape)
            view.copy_(x)
            return view

        if what == "t_starts":
            ts = shifted(ts)
        elif what == "densities":
            dens = shifted(dens)
        elif what == "values":
            vals = shifted(vals)
        elif grads[1] is not None:
            grads = (grads[0], shifted(grads[1])) + grads[2:]
        out = composite_along_rays_bwd(ts, te, dens, vals, sets, grads)
        _check_composite_bwd(out, composite_along_rays_bwd_ref(ts, te, dens, vals, sets, grads))


def _interlevel_case(dev, seed, r, k1, m1s):
    g = torch.Generator(device=dev).manual_seed(seed)

    def edges(n):  # strictly increasing from 0 to 1
        e = torch.cumsum(torch.rand((r, n), device=dev, generator=g) + 0.05, -1)
        e = e - e[:, :1]
        return (e / e[:, -1:]).contiguous()

    def cdf(n):
        c = torch.cumsum(torch.rand((r, n), device=dev, generator=g) ** 4, -1)
        c = c - c[:, :1]
        return (c / c[:, -1:] * 0.98).contiguous()

    s_final, trans = edges(k1), (1.0 - cdf(k1)[:, :-1]).contiguous()
    return s_final, trans, [edges(m) for m in m1s], [cdf(m) for m in m1s], g


@pytest.mark.cuda
@pytest.mark.parametrize("radii", [(0.03, 0.003), (0.003, 0.03)])
def test_interlevel_levels_kernels_match_plain(cuda, radii):
    """The grouped K5 at the flagship's shapes (K+1 = 65, cache levels of
    129 and 65 edges, 8,192 rays): one forward launch for both levels, held
    to a float64 evaluation as closely as the fp32 plain version (2x its
    error + 1e-6 x max); one backward launch, rtol 1e-5 + 1e-6 x max |grad|
    against the plain version, also through autograd."""
    r = 8192
    s_final, trans, caches_s, cdfs, g = _interlevel_case(cuda, 9, r, 65, (129, 65))
    before = interlevel_loss_levels.launches
    loss = interlevel_loss_levels(caches_s, cdfs, s_final, trans, radii)
    assert interlevel_loss_levels.launches == before + 1 and loss.shape == (2, r)
    w_ref, loss_ref = interlevel_loss_levels_ref(caches_s, cdfs, s_final, trans, radii)
    w64, loss64 = interlevel_loss_levels_ref([x.double() for x in caches_s],
                                             [x.double() for x in cdfs], s_final.double(),
                                             trans.double(), radii)
    from emernerf_torch.ops.stepfuns import _levels_forward

    w_s, again = _levels_forward(caches_s, cdfs, s_final, trans, radii)
    assert torch.equal(again, loss)
    for ours, plain, exact in (*zip(w_s, w_ref, w64), (loss, loss_ref, loss64)):
        err = float((ours.double() - exact).abs().max())
        plain_err = float((plain.double() - exact).abs().max())
        assert err <= 2 * plain_err + 1e-6 * float(exact.abs().max()), (err, plain_err)
        assert torch.isfinite(ours).all()
    gl = torch.rand((2, r), device=cuda, generator=g)
    before = interlevel_loss_levels_bwd.launches
    d = interlevel_loss_levels_bwd(w_ref, cdfs, gl)
    assert interlevel_loss_levels_bwd.launches == before + 1
    for a, b in zip(d, interlevel_loss_levels_bwd_ref(w_ref, cdfs, gl)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))
    leaves = [c.clone().requires_grad_(True) for c in cdfs]
    interlevel_loss_levels(caches_s, leaves, s_final, trans, radii).backward(gl)
    for leaf, b in zip(leaves, interlevel_loss_levels_bwd_ref(w_s, cdfs, gl)):
        torch.testing.assert_close(leaf.grad, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("k1,m1s", [(17, (13, 9)), (65, (129,)), (129, (257, 33, 65)),
                                    (257, (257,) * 8)])
def test_interlevel_levels_kernels_at_other_widths(cuda, k1, m1s):
    """The grouped K5 at every merged-run width (2, 5, 9 and 17 edges a
    lane), one to eight levels (eight 257-edge levels: past 48 KB of shared
    memory per block), 1,031 rays: the float64 hold of the forward and the
    backward's tolerance, per level."""
    r = 1031
    s_final, trans, caches_s, cdfs, g = _interlevel_case(cuda, k1, r, k1, m1s)
    radii = [(0.03, 0.003, 0.01)[i % 3] for i in range(len(m1s))]
    from emernerf_torch.ops.stepfuns import _levels_forward

    w_s, loss = _levels_forward(caches_s, cdfs, s_final, trans, radii)
    w_ref, loss_ref = interlevel_loss_levels_ref(caches_s, cdfs, s_final, trans, radii)
    w64, loss64 = interlevel_loss_levels_ref([x.double() for x in caches_s],
                                             [x.double() for x in cdfs], s_final.double(),
                                             trans.double(), radii)
    for ours, plain, exact in (*zip(w_s, w_ref, w64), (loss, loss_ref, loss64)):
        err = float((ours.double() - exact).abs().max())
        plain_err = float((plain.double() - exact).abs().max())
        assert err <= 2 * plain_err + 1e-6 * float(exact.abs().max()), (err, plain_err)
    gl = torch.rand((len(m1s), r), device=cuda, generator=g)
    for a, b in zip(interlevel_loss_levels_bwd(w_ref, cdfs, gl),
                    interlevel_loss_levels_bwd_ref(w_ref, cdfs, gl)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))


@pytest.mark.cuda
def test_interlevel_kernels_match_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    r = 1024

    def edges(k1):  # strictly increasing from 0 to 1
        s = torch.cumsum(torch.rand((r, k1), device=cuda, generator=g) + 0.05, -1)
        s = s - s[:, :1]
        return (s / s[:, -1:]).contiguous()

    def cdf(k1):
        c = torch.cumsum(torch.rand((r, k1), device=cuda, generator=g) ** 4, -1)
        c = c - c[:, :1]
        return (c / c[:, -1:] * 0.98).contiguous()

    s_final, trans = edges(65), (1.0 - cdf(65)[:, :-1]).contiguous()
    cs, cc = edges(129), cdf(129)
    for rad in (0.03, 0.003):
        w_s, loss = _interlevel_forward(s_final, trans, rad, cs, cc)
        w_ref, loss_ref = interlevel_loss_ref(s_final, trans, rad, cs, cc)
        # the blurred pdf sums jumps |y| / (2r) that cancel: fp32 sums in
        # any order sit far from the exact value, so the kernel is held to
        # be as close to a float64 evaluation as the fp32 plain version
        w64, loss64 = interlevel_loss_ref(*(x.double() for x in (s_final, trans)), rad,
                                          cs.double(), cc.double())
        for ours, plain, exact in ((w_s, w_ref, w64), (loss, loss_ref, loss64)):
            err = float((ours.double() - exact).abs().max())
            plain_err = float((plain.double() - exact).abs().max())
            assert err <= 2 * plain_err + 1e-6 * float(exact.abs().max()), (err, plain_err)
            assert torch.isfinite(ours).all()
        gl = torch.rand((r,), device=cuda, generator=g)
        d, d_ref = interlevel_loss_bwd(w_ref, cc, gl), interlevel_loss_bwd_ref(w_ref, cc, gl)
        torch.testing.assert_close(d, d_ref, rtol=1e-3, atol=1e-4 * float(d_ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("numel", [1000, 1 << 20])
def test_adam_kernel_matches_plain_bit_for_bit(cuda, numel):
    g = torch.Generator(device=cuda).manual_seed(7)
    p = torch.randn((numel,), device=cuda, generator=g)
    adam = make_adam(1e-5)
    state = adam.init([p])
    h = adam.hyper(2, 0.003)
    grad = torch.randn((numel,), device=cuda, generator=g) * 1e-2
    copies = [(p.clone(), state.mu[0].clone(), state.nu[0].clone()) for _ in range(2)]
    for (pp, m, v), fn in zip(copies, (adam_update, adam_update_ref)):
        fn(pp, grad, m, v, h)
        fn(pp, None, m, v, h)  # a step without a gradient
    torch.cuda.synchronize()
    for a, b in zip(*copies):
        assert torch.equal(a, b)
    assert copies[0][1].dtype == (torch.bfloat16 if numel >= 1 << 20 else torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("numel", [1000, 1 << 20])
def test_spmd_adam_kernel_matches_plain_bit_for_bit(cuda, numel):
    """K11's replicated-leaf update, fp32 and bf16 moments (2^20 elements)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    p = torch.randn((numel,), device=cuda, generator=g)
    adam = make_adam(1e-5)
    state = adam.init([p])
    h = adam.hyper(3, 0.003)
    grad = torch.randn((numel,), device=cuda, generator=g) * 1e-2
    copies = [(p.clone(), state.mu[0].clone(), state.nu[0].clone()) for _ in range(2)]
    (pp, m, v), (pr, mr, vr) = copies
    spmd_adam_update([pp], [grad], [m], [v], h)
    spmd_adam_update([pp], [None], [m], [v], h)
    spmd_adam_update_ref(pr, grad, mr, vr, h)
    spmd_adam_update_ref(pr, None, mr, vr, h)
    torch.cuda.synchronize()
    for a, b in zip(*copies):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 594])
def test_embedding_lookup_gradient_is_bit_for_bit_between_runs(cuda, rows):
    """The appearance embedding's gradient at a training batch's shape
    (8,192 rays x 32 samples; the synthetic flagship's 8 rows and Waymo's
    594): embedding_lookup's float64 one-hot products give the same bits
    twice, and with TF32 matmuls allowed (nn.Embedding's backward need not
    give the same bits twice)."""
    from emernerf_torch.models.fields import embedding_lookup

    g = torch.Generator(device=cuda).manual_seed(12)
    weight = torch.randn((rows, 16), device=cuda, generator=g, requires_grad=True)
    idx = torch.randint(0, rows, (8192, 1), device=cuda, generator=g).expand(-1, 32)
    cot = torch.randn((8192, 32, 16), device=cuda, generator=g)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        grads = []
        for allow in (False, False, True):
            torch.backends.cuda.matmul.allow_tf32 = allow
            grads.append(torch.autograd.grad(embedding_lookup(weight, idx), weight, cot)[0])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    a = grads[0]
    assert all(torch.equal(a, b) for b in grads[1:])
    # against the float64 sums: an fp32 sum over each ray's 32 samples, then
    # float64 sums over the rays rounded once: (32 + 1) 2^-24 sum|terms|
    flat_idx, flat = idx.reshape(-1), cot.reshape(-1, 16).double()
    exact = torch.zeros((rows, 16), dtype=torch.float64, device=cuda).index_add_(0, flat_idx, flat)
    abs_sum = torch.zeros_like(exact).index_add_(0, flat_idx, flat.abs())
    assert bool(((a.double() - exact).abs() <= 33 * 2.0 ** -24 * abs_sum).all())


def _shifted(t, offset):
    """t's values in a buffer ``offset`` elements in (off 16-byte alignment
    for offset 1-3)."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    flat[offset:].copy_(t.reshape(-1))
    return flat[offset:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("n", [1, 3, 8 * 613 + 5, 4096 * 5 + 7])
@pytest.mark.parametrize("wire", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("direction", [torch.float32, torch.bfloat16])
def test_k11_entry_points_match_plain_at_both_widths(cuda, offset, n, wire, moments, direction):
    """Every K11 entry point on operands 16-byte aligned (vector width 8) and
    1-3 elements past it (width 1), on lengths with a tail, for every wire,
    moment and direction dtype: bit for bit with the plain versions."""
    g = torch.Generator(device=cuda).manual_seed(10 + n + offset)

    def rand(scale, dtype=torch.float32, positive=False):
        x = torch.rand if positive else torch.randn
        return _shifted((x((n,), device=cuda, generator=g) * scale).to(dtype), offset)

    p, grad, slab = rand(1.0), rand(1e-2), rand(1e-2, wire)
    mu, nu = rand(1e-3, moments), rand(1e-4, moments, positive=True)
    assert vector_width(p, grad, mu, nu, slab) == (8 if offset == 0 else 1)
    h = make_adam(1e-5).hyper(4, 0.003)
    outs = []
    for kernel in (True, False):
        pp, m, v = (_shifted(x, offset) for x in (p, mu, nu))
        if kernel:
            spmd_adam_update([pp], [grad], [m], [v], h)
        else:
            spmd_adam_update_ref(pp, grad, m, v, h)
        d = _shifted(torch.empty((n,), dtype=direction, device=cuda), offset)
        (zero_slab_update if kernel else zero_slab_update_ref)(slab, pp, m, v, d, 2, h)
        (apply_direction if kernel else apply_direction_ref)(pp, d, h.neg_lr)
        outs.append((pp, m, v, d))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_spmd_adam_update_launches_once_per_table_of_leaves(cuda):
    """More leaves than one launch's descriptor table holds, mixed fp32 and
    bf16 moments, missing gradients, empty, short and misaligned leaves:
    one launch per SPMD_LEAVES_PER_LAUNCH leaves, bit for bit with the
    plain version leaf by leaf."""
    g = torch.Generator(device=cuda).manual_seed(11)
    count = SPMD_LEAVES_PER_LAUNCH + 9
    sizes = [(0 if i == 5 else 1 + (i * 397) % 9000) for i in range(count)]
    params = [torch.randn((k,), device=cuda, generator=g) for k in sizes]
    grads = [None if i % 4 == 1 else _shifted(torch.randn((k,), device=cuda, generator=g) * 1e-2,
                                              i % 3) for i, k in enumerate(sizes)]
    dtypes = [torch.bfloat16 if i % 2 else torch.float32 for i in range(count)]
    mus = [(torch.randn((k,), device=cuda, generator=g) * 1e-3).to(d)
           for k, d in zip(sizes, dtypes)]
    nus = [(torch.rand((k,), device=cuda, generator=g) * 1e-4).to(d)
           for k, d in zip(sizes, dtypes)]
    h = make_adam(1e-5).hyper(2, 0.003)
    # every third leaf aligned, the others 1 or 2 elements past it
    copies = [[[_shifted(x, i % 3) for i, x in enumerate(xs)] for xs in (params, mus, nus)]
              for _ in range(2)]
    launches = spmd_adam_update.launches
    spmd_adam_update(copies[0][0], grads, copies[0][1], copies[0][2], h)
    assert spmd_adam_update.launches - launches == 2
    for p, gr, m, v in zip(*copies[1][:1], grads, *copies[1][1:]):
        spmd_adam_update_ref(p, gr, m, v, h)
    torch.cuda.synchronize()
    for xs, ys in zip(*copies):
        for a, b in zip(xs, ys):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("direction", [torch.float32, torch.bfloat16])
def test_zero_slab_and_apply_direction_kernels_match_plain(cuda, wire, moments, direction):
    """K11's ZeRO slab step (a slab of the flagship's fused grid on 2 ranks,
    (163840, 432) / 8 rows here) and the gathered direction's update, bit for
    bit with the plain versions."""
    g = torch.Generator(device=cuda).manual_seed(9)
    shape = (163840 // 8, 432)
    slab = (torch.randn(shape, device=cuda, generator=g) * 1e-2).to(wire)
    p = torch.randn(shape, device=cuda, generator=g)
    mu = (torch.randn(shape, device=cuda, generator=g) * 1e-3).to(moments)
    nu = (torch.rand(shape, device=cuda, generator=g) * 1e-4).to(moments)
    h = make_adam(1e-5).hyper(4, 0.003)
    outs = []
    for fn, apply in ((zero_slab_update, apply_direction),
                      (zero_slab_update_ref, apply_direction_ref)):
        m, v, pp = mu.clone(), nu.clone(), p.clone()
        d = torch.empty(shape, dtype=direction, device=cuda)
        fn(slab, pp, m, v, d, 2, h)
        apply(pp, d, h.neg_lr)
        outs.append((m, v, d, pp))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _hash_inputs(cuda, dims, f, dtype, seed, n=4096):
    # 6 levels of R = 8 .. 512, T = 2^14: linear coarse levels, hashed fine ones
    spec = HashGridSpec(n_input_dims=dims, n_levels=6, base_resolution=8, max_resolution=512,
                        log2_hashmap_size=14, n_features_per_level=f)
    g = torch.Generator(device=cuda).manual_seed(seed)
    table = (torch.rand(spec.table_shape, device=cuda, generator=g) * 2 - 1).to(dtype)
    pos = torch.rand((n, dims), device=cuda, generator=g)
    pos[:2] = torch.tensor([0.0, 1.0], device=cuda)[:, None]  # corners reach R at x = 1
    return spec, table, pos, g


def _check_hash_forward(spec, table, pos):
    with torch.no_grad():
        out = hashgrid_encode(table, pos, spec)
        ref = hashgrid_encode_plain(table, pos, spec)
    torch.cuda.synchronize()
    # same explicitly rounded fp32 ops in the same order: equal, but for
    # bf16's one rounding of a value whose last fp32 bits may differ
    if table.dtype == torch.float32:
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,f", [(3, 4), (3, 1), (4, 4), (4, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hashgrid_kernel_matches_plain(cuda, dims, f, dtype):
    spec, table, pos, _ = _hash_inputs(cuda, dims, f, dtype, 8)
    assert spec.level_uses_hash.any() and not spec.level_uses_hash.all()
    _check_hash_forward(spec, table, pos)


def _check_hash_backward(spec, table, pos, cot, pos_grad):
    d_t, d_x = hashgrid_encode_bwd(table, pos, cot, spec, pos_grad)
    r_t, r_x = hashgrid_encode_bwd_plain(table, pos, cot, spec, pos_grad)
    torch.cuda.synchronize()
    # fp32 atomics (and warp merges) in another order than index_add_; bf16
    # grads round once
    assert d_t.dtype == table.dtype and d_t.shape == r_t.shape
    rtol = 1e-5 if table.dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(d_t.float(), r_t.float(), rtol=rtol,
                               atol=1e-5 * float(r_t.float().abs().max()))
    if pos_grad:
        # the same fp32 operations in the same order (no atomics)
        torch.testing.assert_close(d_x, r_x, rtol=1e-6, atol=1e-6 * float(r_x.abs().max()))
    else:
        assert d_x is None and r_x is None


@pytest.mark.cuda
@pytest.mark.parametrize("dims,f", [(3, 4), (3, 1), (4, 4), (4, 2), (3, 2), (4, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos_grad", [False, True], ids=["table_only", "with_pos_grad"])
def test_hashgrid_backward_kernel_matches_plain(cuda, dims, f, dtype, pos_grad):
    spec, table, pos, g = _hash_inputs(cuda, dims, f, dtype, 9)
    cot = torch.randn((pos.shape[0], spec.n_output_dims), device=cuda, generator=g).to(dtype)
    _check_hash_backward(spec, table, pos, cot, pos_grad)


def _ray_positions(cuda, g, n_rays, n_samples, dims):
    """Samples along straight rays through the unit cube, ray-major: each
    ray from a point on the cube's x = 0 face towards the x = 1 face; a 4D
    point carries its ray's time."""
    start = torch.rand((n_rays, 1, 3), device=cuda, generator=g)
    end = torch.rand((n_rays, 1, 3), device=cuda, generator=g)
    start[..., 0], end[..., 0] = 0.0, 1.0
    s = torch.linspace(0.0, 1.0, n_samples, device=cuda)[None, :, None]
    pts = start + s * (end - start)
    if dims == 4:
        t = torch.rand((n_rays, 1, 1), device=cuda, generator=g).expand(-1, n_samples, 1)
        pts = torch.cat([pts, t], -1)
    return pts.reshape(-1, dims).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dims,f", [(3, 4), (4, 4), (3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hashgrid_backward_kernel_on_ray_ordered_points(cuda, dims, f, dtype):
    """Ray-major samples: neighbouring lanes share rows on the coarse
    levels, so the warp merges runs before its atomics."""
    spec, table, _, g = _hash_inputs(cuda, dims, f, dtype, 13)
    pos = _ray_positions(cuda, g, 96, 64, dims)
    cot = torch.randn((pos.shape[0], spec.n_output_dims), device=cuda, generator=g).to(dtype)
    _check_hash_backward(spec, table, pos, cot, True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_cell", "equal_rows_per_warp", "n_not_multiple_of_32"])
@pytest.mark.parametrize("dims,f", [(4, 4), (3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hashgrid_backward_kernel_worst_contention(cuda, case, dims, f, dtype):
    """Every point in one coarse cell (every lane of every warp on the same
    rows of the coarse levels); each warp's 32 points equal (one run of 32
    on every level); and 1,000 points (a last warp of 8 live lanes).  F = 1
    also pairs neighbouring corners into one float2 atomic."""
    spec, table, pos, g = _hash_inputs(cuda, dims, f, dtype, 14)
    if case == "one_cell":
        pos = 0.5 + 0.01 * torch.rand(pos.shape, device=cuda, generator=g)
    elif case == "equal_rows_per_warp":
        pos = pos[::32].repeat_interleave(32, 0).contiguous()
    else:
        pos = pos[:1000].contiguous()
    cot = torch.randn((pos.shape[0], spec.n_output_dims), device=cuda, generator=g).to(dtype)
    for pos_grad in (False, True):
        _check_hash_backward(spec, table, pos, cot, pos_grad)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rays", "one_cell", "n_not_multiple_of_32"])
@pytest.mark.parametrize("dims,f", [(3, 4), (4, 4), (3, 1), (4, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hashgrid_kernel_on_rays_and_contended_points(cuda, case, dims, f, dtype):
    """K4 forward on ray-major samples (neighbouring lanes on the same
    rows), on points all in one coarse cell, and on 1,000 points (the last
    block's output tile holds 8 rows)."""
    spec, table, pos, g = _hash_inputs(cuda, dims, f, dtype, 18)
    if case == "rays":
        pos = _ray_positions(cuda, g, 96, 64, dims)
    elif case == "one_cell":
        pos = 0.5 + 0.01 * torch.rand(pos.shape, device=cuda, generator=g)
    else:
        pos = pos[:1000].contiguous()
    _check_hash_forward(spec, table, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_features_minor_kernel_matches_plain(cuda, f, dtype):
    g = torch.Generator(device=cuda).manual_seed(19)
    table = torch.randn((f, (1 << 16) + 37), device=cuda, generator=g).to(dtype)
    before = features_minor.launches
    out = features_minor(table)
    assert features_minor.launches == before + 1
    assert torch.equal(out, features_minor_plain(table))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,f", [(4, 4), (3, 1)])
def test_hashgrid_autograd_on_the_card(cuda, dims, f):
    """hashgrid_encode's forward reads the table's features-minor copy
    (made by features_minor_kernel for F > 1, a view for F = 1), saves it
    and its backward launches K4's backward on it: the plain version's
    encoding and position gradient bit for bit, its table gradient within
    the atomics' order."""
    spec, table, pos, g = _hash_inputs(cuda, dims, f, torch.float32, 10)
    t = table.clone().requires_grad_(True)
    x = pos.clone().requires_grad_(True)
    cot = torch.randn((pos.shape[0], spec.n_output_dims), device=cuda, generator=g)
    before = (hashgrid_encode.launches, hashgrid_encode_bwd.launches, features_minor.launches)
    out = hashgrid_encode(t, x, spec)
    out.backward(cot)
    after = (hashgrid_encode.launches, hashgrid_encode_bwd.launches, features_minor.launches)
    assert after == (before[0] + 1, before[1] + 1, before[2] + (f > 1))
    assert torch.equal(out.detach(), hashgrid_encode_plain(table, pos, spec))
    r_t, r_x = hashgrid_encode_bwd_plain(table, pos, cot, spec, True)
    torch.testing.assert_close(t.grad, r_t, rtol=1e-5, atol=1e-5 * float(r_t.abs().max()))
    assert torch.equal(x.grad, r_x)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", [gs.row_gather_loop, gs.row_gather_take], ids=["P1", "P2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_kernels_match_plain_bit_for_bit(cuda, fn, dtype):
    g = torch.Generator(device=cuda).manual_seed(11)
    table = torch.randn((1 << 12, 128), device=cuda, generator=g).to(dtype)
    idx = torch.randint(0, 1 << 12, (3 * gs.TILE + 5,), device=cuda, generator=g,
                        dtype=torch.int32)
    before = fn.launches
    out = fn(table, idx)
    assert fn.launches == before + 1
    assert torch.equal(out, gs.row_gather_plain(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [1, 3, 8, 127, 128, 129, 512])
def test_row_gather_loop_widths_and_offsets_bit_for_bit(cuda, w, dtype):
    """P1 at odd and wide rows, on table views at an element offset (the
    vector width p1_plan picks drops with the alignment), with row counts
    that leave a ragged last tile of 32 rows, none, and thousands of
    blocks; bit for bit with index_select and between two runs."""
    g = torch.Generator(device=cuda).manual_seed(40 + w)
    t = 1000
    flat = torch.randn((t * w + 8,), device=cuda, generator=g).to(dtype)
    for offset in (0, 1, 2, 4):
        table = flat[offset:offset + t * w].view(t, w)
        for n in (0, 1, 31, 33, 200_003):
            idx = torch.randint(0, t, (n,), device=cuda, generator=g, dtype=torch.int32)
            before = gs.row_gather_loop.launches
            out = gs.row_gather_loop(table, idx)
            assert gs.row_gather_loop.launches == before + (n > 0)
            assert out.shape == (n, w) and out.dtype == dtype
            assert torch.equal(out, gs.row_gather_plain(table, idx)), (offset, n)
    assert torch.equal(gs.row_gather_loop(table, idx), out)


@pytest.mark.cuda
@pytest.mark.parametrize("t,w,tile_n", [(1 << 13, 128, gs.TILE), (512, 108, 2048),
                                        (4096, 432, 1024), (200, 40, 64)])
def test_scatter_add_kernels_match_plain(cuda, t, w, tile_n):
    """P3 (atomics) and P4 (the scatter-add of bf16-rounded rows, by the
    route p4_plan picks) against index_add_: fp32 sums in another order,
    within 1e-5 of the largest |value|."""
    g = torch.Generator(device=cuda).manual_seed(12)
    n = 4 * max(tile_n, gs.TILE)
    rows = torch.randint(0, t, (n,), device=cuda, generator=g, dtype=torch.int32)
    upd = torch.randn((n, w), device=cuda, generator=g)
    for fn, plain, args in ((gs.scatter_add_rmw, gs.scatter_add_plain, ()),
                            (gs.scatter_add_onehot, gs.scatter_add_onehot_plain, (tile_n,))):
        before = fn.launches
        out = fn(rows, upd, t, *args)
        assert fn.launches == before + 1
        ref = plain(rows, upd, t)
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


# (n, w, element offset of the update view, every index 0): the probe's
# shape, odd widths (the float and float2 instances; a warp's run of 32
# rows of 130 floats ends inside a step of 8 vectors per lane), update
# views at a 4- and 8-byte offset (p3_plan narrows), and the worst
# contention
_P3_CASES = [(1 << 22, 128, 0, False), (1 << 14, 1, 0, False), (1 << 14, 3, 0, False),
             (1 << 14, 6, 0, False), (6144, 130, 0, False), (1 << 16, 128, 1, False),
             (1 << 16, 128, 2, False), (1 << 16, 6, 1, False), (4096, 128, 0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,offset,equal", _P3_CASES)
def test_scatter_rmw_widths_offsets_and_contention(cuda, n, w, offset, equal):
    """P3 (a warp per 32 update rows, vector reductions of the width
    p3_plan picks) against index_add_ into zeros: fp32 sums in another
    order, within 1e-5 of the largest |value|; one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(50 + w)
    t = 1 << 13
    idx = torch.randint(0, t, (n,), device=cuda, generator=g, dtype=torch.int32)
    if equal:
        idx.zero_()
    upd = torch.randn((n * w + offset,), device=cuda, generator=g)[offset:].view(n, w)
    out = torch.zeros((t, w), device=cuda)
    assert gs.p3_plan(w, upd.data_ptr(), out.data_ptr()) == max(
        v for v in (16, 8, 4) if (4 * w) % v == 0 and (4 * offset) % v == 0)
    before = gs.scatter_add_rmw.launches
    out = gs.scatter_add_rmw(idx, upd, t)
    assert gs.scatter_add_rmw.launches == before + 1
    ref = gs.scatter_add_plain(idx, upd, t)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


# (t, w, rows): a table that fits shared memory (221,184 bytes), one that
# does not (259,200 bytes), the largest probe table, every update row on
# one table row on each side of the limit, w not a multiple of 4
_P4_CASES = [(512, 108, "random"), (600, 108, "random"), (4096, 432, "random"),
             (700, 60, "all_equal"), (4096, 432, "all_equal"), (131, 7, "random")]


@pytest.mark.cuda
@pytest.mark.parametrize("t,w,rows_kind", _P4_CASES)
def test_scatter_onehot_routes_match_plain(cuda, t, w, rows_kind):
    """P4 by the route p4_plan picks for the table, with several tiles per
    block (n = 1,024 tiles of 64 rows over the card's blocks), within 1e-5
    of the largest |value| of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(15)
    n = 1024 * 64
    rows = torch.randint(0, t, (n,), device=cuda, generator=g, dtype=torch.int32)
    if rows_kind == "all_equal":
        rows.fill_(t // 2)
    upd = torch.randn((n, w), device=cuda, generator=g)
    before = gs.scatter_add_onehot.launches
    out = gs.scatter_add_onehot(rows, upd, t, 64)
    assert gs.scatter_add_onehot.launches == before + 1
    ref = gs.scatter_add_onehot_plain(rows, upd, t)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
def test_probe_wrappers_reject_out_of_range_rows(cuda):
    idx = torch.full((gs.TILE,), 9, device=cuda, dtype=torch.int32)
    upd = torch.ones((gs.TILE, 8), device=cuda)
    with pytest.raises(ValueError, match="indices must lie"):
        gs.scatter_add_rmw(idx, upd, 4)
    with pytest.raises(ValueError, match="indices must lie"):
        gs.row_gather_loop(upd, idx.clone().fill_(gs.TILE))


def _point_chunk(cuda, dims, n=65536, voxel_size=1.0):
    """A point-query chunk as PointQueryEngine sends it: the first n cells of
    the synthetic flagship scene's voxel grid (eval/voxel_vis.py:voxel_grid),
    contracted as the fields contract them, at one timestamp in 4D."""
    from emernerf_torch.data.synthetic import make_synthetic_scene
    from emernerf_torch.eval.voxel_vis import voxel_grid
    from emernerf_torch.models.fields import _contract

    aabb = make_synthetic_scene(num_frames=8, num_cams=1, hw=(8, 12), dynamic=True)["aabb"]
    world = torch.from_numpy(voxel_grid(aabb, voxel_size)[:n].astype(np.float32)).to(cuda)
    pos = _contract(world, torch.from_numpy(aabb).to(cuda), True)
    if dims == 4:
        pos = torch.cat([pos, torch.full_like(pos[:, :1], 3 / 7)], -1)
    return pos.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dims,f,bs,pair", [_BRICK_LAYOUTS[1], _BRICK_LAYOUTS[2]],
                         ids=["static_3d", "fused_4d"])
@pytest.mark.parametrize("stored,compute", _K1_TYPES[:2], ids=_K1_TYPE_IDS[:2])
def test_brickgrid_kernel_at_a_point_query_chunk(cuda, dims, f, bs, pair, stored, compute):
    """K1 forward at an (N, 3) and an (N, 4) point-query chunk (a regular
    lattice: neighbouring lanes on neighbouring cells) bit for bit."""
    spec = _brick_spec(dims, f, bs, pair)
    g = torch.Generator(device=cuda).manual_seed(40)
    table = (torch.rand(spec.table_shape, device=cuda, generator=g) * 2 - 1).to(stored)
    pos = _point_chunk(cuda, dims)
    with torch.no_grad():
        out = brickgrid_encode(table, pos, spec, compute)
        ref = brickgrid_encode_ref(table, pos, spec, compute)
    torch.cuda.synchronize()
    assert out.shape == (65536, spec.n_output_dims) and torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,f", [(3, 4), (4, 4)], ids=["static_3d", "dynamic_4d"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hashgrid_kernel_at_a_point_query_chunk(cuda, dims, f, dtype):
    spec, table, _, _ = _hash_inputs(cuda, dims, f, dtype, 41)
    _check_hash_forward(spec, table, _point_chunk(cuda, dims))


@pytest.mark.cuda
def test_composite_forward_kernel_at_the_pruned_eval_shape(cuda):
    """K3 forward at the top-K eval's final composite: 16,384 rays of 64
    samples, three density sets, 23 channels, every field output zero but
    at the 32 shaded samples of each ray (as the scatter-back leaves them)."""
    g = torch.Generator(device=cuda).manual_seed(42)
    r, s, k = 16384, 64, 32
    t = torch.sort(torch.rand((r, s + 1), device=cuda, generator=g) * 100, -1)[0] + 0.1
    ts, te = t[:, :-1].contiguous(), t[:, 1:].contiguous()
    kept = torch.rand((r, s), device=cuda, generator=g).argsort(-1)[:, :k]
    mask = torch.zeros((r, s, 1), device=cuda).scatter_(1, kept[..., None], 1.0)
    dens = torch.rand((r, s, 3), device=cuda, generator=g) ** 3 * 0.5 * mask
    dens[..., 0] = dens[..., 1] + dens[..., 2]
    vals = torch.rand((r, s, 23), device=cuda, generator=g) * mask
    sets = [0] * 4 + [1] * 9 + [0] + [2] * 9
    out = composite_along_rays(ts, te, dens, vals, sets)
    ref = composite_along_rays_ref(ts, te, dens, vals, sets)
    torch.cuda.synchronize()
    _check_composite_forward(out, ref, ts, te)
    assert float((out.weights == 0).float().mean()) >= 0.5


# the feature head's K3 calls: the pixel branch's (shadow 1 + rgb 3 +
# dino 64 channels, one density set), the eval's with decomposition (23 +
# dino_feat, static_dino and dynamic_dino at 64 each), an odd width and
# the widest; each beside a ragged shape (rays, samples per lane)
_WIDE_K3 = [(8192, 64, 1, 68), (4099, 64, 3, 97), (16384, 64, 3, 215), (2053, 128, 3, 256),
            (1031, 33, 2, 215)]


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,d,c", _WIDE_K3,
                         ids=[f"R{r}_S{s}_D{d}_C{c}" for r, s, d, c in _WIDE_K3])
def test_composite_kernels_past_64_channels_match_plain(cuda, r, s, d, c):
    """K3 forward and backward above 64 value channels (the weights, then
    the sums kernel, counted as two launches) against the plain versions,
    with random channel sets; the backward with every cotangent and with
    all but the sums' (d values exactly zero); two runs bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(7 * c + d + s)
    t = torch.sort(torch.rand((r, s + 1), device=cuda, generator=g) * 50, -1)[0] + 0.1
    ts, te = t[:, :-1].contiguous(), t[:, 1:].contiguous()
    dens = torch.rand((r, s, d), device=cuda, generator=g) ** 3 * 0.2
    dens[:5] = 0.0  # empty rays: opacity clipped to 1e-6
    vals = torch.rand((r, s, c), device=cuda, generator=g)
    sets = [int(x) for x in torch.randint(0, d, (c,), generator=torch.Generator().manual_seed(c))]
    before = composite_along_rays.launches
    out = composite_along_rays(ts, te, dens, vals, sets)
    again = composite_along_rays(ts, te, dens, vals, sets)
    assert composite_along_rays.launches == before + 4  # two kernels a call
    ref = composite_along_rays_ref(ts, te, dens, vals, sets)
    torch.cuda.synchronize()
    _check_composite_forward(out, ref, ts, te)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    del out, again, ref
    rnd = lambda *shape: torch.randn(shape, device=cuda, generator=g)  # noqa: E731
    for grads in ((rnd(r, s, d), rnd(r, s, d), rnd(r, d), rnd(r, d), rnd(r, c)),
                  (rnd(r, s, d), None, rnd(r, d), None, None)):
        out = composite_along_rays_bwd(ts, te, dens, vals, sets, grads)
        _check_composite_bwd(out, composite_along_rays_bwd_ref(ts, te, dens, vals, sets, grads))
        again = composite_along_rays_bwd(ts, te, dens, vals, sets, grads)
        assert all(torch.equal(a, b) for a, b in zip(out, again))
        if grads[4] is None:
            assert not out[1].any()


@pytest.mark.cuda
def test_composite_kernel_refuses_257_channels(cuda):
    ts = torch.sort(torch.rand((4, 9), device=cuda), -1)[0]
    dens = torch.rand((4, 8, 1), device=cuda)
    with pytest.raises(ValueError, match="one density set per value channel"):
        composite_along_rays(ts[:, :-1].contiguous(), ts[:, 1:].contiguous(), dens,
                             torch.rand((4, 8, 257), device=cuda), [0] * 257)
