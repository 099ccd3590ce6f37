"""Host-side helpers of ``chip_smoke.py`` that size and explain its
measurements: the ray-ordered sample batches, the count of distinct rows
(and runs of equal rows) per warp that K4 backward's warp merge acts on,
the shares of a training profile, the census of casts of tensors the
size of a grid table, the grid specs and queries phases 9 and 10 check
K1 on, and the kernel times alone (a mean per profiler record, none
under the bound)."""

import numpy as np
import pytest
import torch

import chip_smoke
from emernerf_torch.flagship import DYNAMIC, REFERENCE_BRICK, build_flagship
from emernerf_torch.ops.hashgrid import HashGridSpec, _level_geometry, level_constants


@pytest.mark.parametrize("dims", [3, 4])
def test_warp_rows_matches_a_count_by_hand(dims):
    spec = HashGridSpec(n_input_dims=dims, n_levels=3, base_resolution=4, max_resolution=64,
                        log2_hashmap_size=10, n_features_per_level=2)
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.random((100, dims), dtype=np.float32))
    pos[32:64] = pos[32]  # one warp of equal points: one run per corner
    pos[64:96:2] = pos[65:96:2]  # pairs of equal neighbours
    stats = chip_smoke.warp_rows(spec, pos)
    consts = level_constants(spec)
    assert len(stats) == spec.n_levels
    for lvl, (distinct, runs) in enumerate(stats):
        d, r = [], []
        for corner in _level_geometry(pos[:96], spec, lvl, consts)[0]:
            for w in range(3):  # the last 4 points fill no warp
                seg = corner[32 * w:32 * (w + 1)].tolist()
                d.append(len(set(seg)))
                r.append(1 + sum(seg[i] != seg[i - 1] for i in range(1, 32)))
        assert distinct == pytest.approx(np.mean(d))
        assert runs == pytest.approx(np.mean(r))
        assert distinct <= runs
    # the equal warp: one row per corner on every level
    one = chip_smoke.warp_rows(spec, pos[32:64])
    assert all(d == 1.0 and r == 1.0 for d, r in one)


def test_ray_batches_are_ray_major_and_stack_the_warped_thirds():
    g = torch.Generator().manual_seed(0)
    xyz, xyzt = chip_smoke.ray_batches("cpu", g, 5, 16)
    assert xyz.shape == (80, 3) and xyzt.shape == (240, 4)
    assert xyz.is_contiguous() and xyzt.is_contiguous()
    assert float(xyz.min()) >= 0.0 and float(xyz.max()) <= 1.0
    assert float(xyzt.min()) >= 0.0 and float(xyzt.max()) <= 1.0
    rays = xyz.reshape(5, 16, 3)
    # each ray crosses the cube from x = 0 to x = 1, its samples in order
    assert torch.all(rays[:, 0, 0] == 0.0) and torch.all(rays[:, -1, 0] == 1.0)
    assert torch.all(rays[:, 1:, 0] > rays[:, :-1, 0])
    cur, fwd, bwd = xyzt.reshape(3, 5, 16, 4).unbind(0)
    assert torch.equal(cur[..., :3], rays)
    assert torch.all(cur[..., 3] == cur[:, :1, 3])  # one time per ray
    assert torch.allclose(fwd[..., 3], (cur[..., 3] + 1 / 8).clamp(0, 1))
    assert torch.allclose(bwd[..., 3], (cur[..., 3] - 1 / 8).clamp(0, 1))
    assert float((fwd[..., :3] - rays).abs().max()) <= 0.02 + 1e-6


def test_profile_shares_sums_the_matching_kernels():
    rows = [("void brickgrid_encode_kernel<float, __nv_bfloat16, 8>", 4.0, 20),
            ("void at::native::vectorized_elementwise_kernel<4, direct_copy_kernel_cuda>", 2.0, 8),
            ("void at::native::vectorized_elementwise_kernel<4, FillFunctor<float>>", 1.0, 4),
            ("Memset (Device)", 1.0, 4), ("void round_to_bf16_kernel", 0.5, 6),
            ("sgemm", 11.5, 40)]
    busy = sum(t for _, t, _ in rows) / 2  # ms per iteration over 2 profiled ones
    shares = chip_smoke.profile_shares(rows, busy)
    assert shares["K1 forward"] == pytest.approx(4.0 / 20.0)
    assert shares["copies, casts and fills"] == pytest.approx(4.0 / 20.0)
    assert shares["K1 backward's bf16 rounding pass"] == pytest.approx(0.5 / 20.0)
    assert shares["K4 forward"] == 0.0


class _Step:
    """A stand-in for Trainer: one iteration casts a 'table' of 6 elements
    to bf16 and back in the forward, and its backward casts the gradient."""

    def __init__(self):
        self.table = torch.ones(2, 3, requires_grad=True)

    def train_iteration(self, step):
        out = self.table.to(torch.bfloat16).float() * 2.0
        out.sum().backward()
        torch.arange(6).to(torch.float32)  # an integer cast is no table cast
        torch.ones(5).to(torch.bfloat16)  # another size


def test_table_casts_lists_forward_and_backward_casts_of_table_sized_tensors():
    casts = chip_smoke.table_casts(_Step(), 0, {6})
    assert casts and all(n == 6 for _, n, _, _ in casts)
    pairs = [(a, b) for _, _, a, b in casts]
    # the forward's two casts, then the backward's through both of them
    assert pairs.count(("float32", "bfloat16")) == 2
    assert pairs.count(("bfloat16", "float32")) == 2


def test_remade_makes_its_inputs_on_first_use_and_once():
    made = []

    def make():
        made.append(1)
        return torch.arange(3.0), 2.0

    run = chip_smoke.remade(make, lambda x, k: x * k)
    assert made == []  # nothing is held before the first call
    assert torch.equal(run(), torch.tensor([0.0, 2.0, 4.0]))
    assert torch.equal(run(), torch.tensor([0.0, 2.0, 4.0]))
    assert made == [1]


def test_profiled_ms_takes_each_kernels_mean_over_its_records(monkeypatch):
    """A session that lost records (the weights kernel kept 7 of 20, the
    sums kernel all 20) still gives each kernel's time per call; a session
    that kept none gives no time."""
    from types import SimpleNamespace as Rec

    records = [Rec(key="void composite_kernel<2>(float const*)", device_time_total=35.0,
                   count=7),
               Rec(key="void composite_sums_kernel(float const*)", device_time_total=1320.0,
                   count=20),
               Rec(key="void at::native::fill_kernel(float*)", device_time_total=99.0, count=20)]
    session = Rec(key_averages=lambda: records)
    monkeypatch.setattr(chip_smoke, "cuda_profile", lambda run: (run(), session)[1])
    monkeypatch.setattr(chip_smoke.torch.cuda, "synchronize", lambda: None)
    calls = []
    ms, n = chip_smoke.profiled_ms(lambda: calls.append(1), ("composite_kernel",
                                                            "composite_sums_kernel"), iters=20)
    assert len(calls) == 21  # a warm-up call, then the session's
    assert ms == pytest.approx((35.0 / 7 + 1320.0 / 20) / 1e3) and n == 27
    records[:] = []
    assert chip_smoke.profiled_ms(lambda: None, ("composite_kernel",)) == (None, 0)


@pytest.mark.parametrize("ms,reported", [(0.30, 0.30), (0.25, None), (None, None)])
def test_kernel_only_time_under_its_bound_is_not_reported(ms, reported):
    entry = {"bound_ms": 0.2873, "kernel_only_ms": 1.0}
    text = chip_smoke.set_kernel_only(entry, ms)
    assert entry.get("kernel_only_ms") == reported
    assert ("not reported" in text) == (reported is None)


def _tiny_flagship_config(monkeypatch):
    import emernerf_torch.flagship as fl

    full = fl.flagship_config
    monkeypatch.setattr(fl, "flagship_config",
                        lambda tiny=False, overrides=(), profile=fl.DEFAULT_PROFILE:
                        full(True, overrides, profile))


def test_reference_brick_specs_are_the_built_models_unpaired_grids(monkeypatch):
    """Phase 10's K1 shapes are those of the reference-brick model the
    trainer builds: separate dynamic and flow grids of unpaired 4D rows
    (compared at the tiny size, which keeps make_grid_spec's row pairing)."""
    _tiny_flagship_config(monkeypatch)
    specs = chip_smoke.profile_specs(REFERENCE_BRICK)
    _, _, model, _, _ = build_flagship(tiny=True, profile=REFERENCE_BRICK, device="cpu")
    assert specs["dynamic"] == model.dynamic_spec
    for spec in specs.values():
        assert spec.has_time and not spec.uses_time_pair
    # the flow grid's structure is fixed (the tiny model's is shrunk)
    assert (specs["flow"].n_levels, specs["flow"].n_features_per_level) == (10, 4)


def test_dynamic_specs_are_the_built_models_paired_dynamic_grid(monkeypatch):
    """Phase 9's K1 shapes are those of the dynamic-only model: its dynamic
    grid alone, of paired 4D rows."""
    _tiny_flagship_config(monkeypatch)
    specs = chip_smoke.profile_specs(DYNAMIC)
    _, _, model, _, _ = build_flagship(tiny=True, profile=DYNAMIC, device="cpu")
    assert list(specs) == ["dynamic"] and model.flow_spec is None
    assert specs["dynamic"] == model.dynamic_spec and specs["dynamic"].uses_time_pair


@pytest.mark.parametrize("flow", [False, True], ids=["no_flow", "flow"])
def test_profile_grid_cases_split_the_ray_batch_as_the_fields_query_it(flow):
    """Without flow the dynamic grid takes the current samples only; with
    flow the dynamic grid takes the whole [current; +warp; -warp] batch
    with position gradients, the flow grid the current third, then the
    warped two thirds with position gradients."""
    g = torch.Generator().manual_seed(0)
    _, xyzt = chip_smoke.ray_batches("cpu", g, 4, 8)
    specs = {"dynamic": None, **({"flow": None} if flow else {})}
    cases = chip_smoke.profile_grid_cases(specs, xyzt, 32)
    got = [(name, pos.shape[0], pos_grad) for name, pos, pos_grad in cases]
    if flow:
        assert got == [("dynamic", 96, True), ("flow", 32, False), ("flow", 64, True)]
        assert torch.equal(cases[2][1], xyzt[32:])
    else:
        assert got == [("dynamic", 32, False)]
    assert torch.equal(cases[0][1][:32], xyzt[:32])


def test_composite_inputs_keep_zeroes_all_but_the_shaded_samples():
    """The pruned eval's K3 inputs: per ray exactly ``keep`` samples carry a
    density and values, as the scatter-back of a top-K render leaves them."""
    ts, te, dens, vals = chip_smoke.composite_inputs("cpu", 3, 50, 16, 3, 5, 80.0, False, keep=6)
    full = chip_smoke.composite_inputs("cpu", 3, 50, 16, 3, 5, 80.0, False)
    assert torch.equal(ts, full[0]) and torch.equal(te, full[1])
    live = (dens[..., 1:] > 0).any(-1)
    assert torch.all(live.sum(-1) == 6)
    assert torch.equal(dens[live], full[2][live]) and torch.all(vals[~live] == 0)
    assert torch.equal(dens[..., 0], dens[..., 1] + dens[..., 2])


def test_point_batches_are_the_point_queries_of_the_flagship_scene():
    """Phase 12b's grid queries: the first chunk of the voxel grid
    contracted as the fields contract it, the same at one training
    timestamp, the warped 2N batch, and the flow eval's scored lidar
    returns of frame 0 at their timestamps."""
    from emernerf_torch.builders import build_dataset_from_cfg
    from emernerf_torch.eval.flow import flow_eval_points
    from emernerf_torch.eval.voxel_vis import voxel_grid
    from emernerf_torch.flagship import flagship_config
    from emernerf_torch.models.fields import _contract

    n = 1000
    b = chip_smoke.point_batches("cpu", torch.Generator().manual_seed(0), n=n)
    dataset = build_dataset_from_cfg(flagship_config())
    aabb = torch.from_numpy(dataset.aabb)
    world = torch.from_numpy(voxel_grid(dataset.aabb, chip_smoke.VIS_VOXEL_SIZE)[:n]).float()
    assert torch.equal(b["voxels"], _contract(world, aabb, True))
    assert torch.equal(b["voxels_t"][:, :3], b["voxels"])
    assert float(b["voxels_t"][0, 3]) in dataset.unique_normalized_training_timestamps
    assert b["voxels_warped"].shape == (2 * n, 4)
    assert torch.all((b["voxels_warped"] >= 0) & (b["voxels_warped"] <= 1))
    pts, t, _ = flow_eval_points(dataset, 0)
    assert torch.equal(b["lidar"][:, :3], _contract(torch.from_numpy(pts), aabb, True))
    np.testing.assert_array_equal(b["lidar"][:, 3].numpy(), t)
