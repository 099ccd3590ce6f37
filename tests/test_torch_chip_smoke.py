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


def test_raw_record_decodes_to_waymo_shapes_and_preprocesses(tmp_path):
    """Phase 16a's writer at one frame: Waymo's five cameras (JPEGs at
    their sizes), the TOP lidar's 64 x 2650 range image with its per-pixel
    pose, four 200 x 600 short lidars, flow images of the same shapes and
    the labels; the preprocessor's rows of it pass phase 16b's check, and
    a moved point fails it."""
    import io

    from PIL import Image

    from emernerf_torch.tools import waymo_wire as ww
    from emernerf_torch.tools.preprocess import WaymoProcessor, parse_flow_range_images

    raw = tmp_path / "raw"
    raw.mkdir()
    truth = chip_smoke.write_raw_tfrecord(str(raw / "seg.tfrecord"), n_frames=1)
    (rec,) = list(ww.read_tfrecords(str(raw / "seg.tfrecord")))
    frame = ww.parse_frame(rec)
    sizes = {c.name: (c.width, c.height) for c in frame.context.camera_calibrations}
    assert sizes == {1: (1920, 1280), 2: (1920, 1280), 3: (1920, 1280), 4: (1920, 886),
                     5: (1920, 886)}
    assert {img.name: Image.open(io.BytesIO(img.image)).size for img in frame.images} == sizes
    ri, _, _, top_pose = ww.parse_range_image_and_camera_projection(frame)
    shapes = {1: (64, 2650, 4), **{n: (200, 600, 4) for n in (2, 3, 4, 5)}}
    assert {k: tuple(v[0].shape.dims) for k, v in ri.items()} == shapes
    assert tuple(top_pose.shape.dims) == (64, 2650, 6)
    assert {k: v.shape for k, v in parse_flow_range_images(frame).items()} == shapes
    assert len(frame.context.laser_calibrations[0].beam_inclinations) == 64
    speeds = sorted(np.hypot(b.metadata.speed_x, b.metadata.speed_y) > 1.0
                    for b in frame.laser_labels)
    assert speeds == [False, True, True, True]  # the parked one stands
    assert sum(b.num_top_lidar_points_in_box == 0 for b in frame.laser_labels) == 1

    WaymoProcessor(str(raw), str(tmp_path / "out"), [0], ["seg"], workers=1).convert_one(0)
    scene = str(tmp_path / "out" / "000")
    n = chip_smoke.check_preprocessed(scene, truth)
    assert n == sum(int((t["range"] > 0).sum()) for t in truth[0].values())
    mask = np.asarray(Image.open(tmp_path / "out" / "000" / "dynamic_masks" / "000_0.png"))
    assert mask.shape == (1280, 1920) and mask.any()
    rows = np.fromfile(f"{scene}/lidar/000.bin", np.float32).reshape(-1, 14)
    rows[7, 3] += 0.5
    rows.tofile(f"{scene}/lidar/000.bin")
    with pytest.raises(SystemExit, match="distances"):
        chip_smoke.check_preprocessed(scene, truth)


def test_hub_model_has_dinov2_vitb14_shapes_and_grid(tmp_path):
    """Phase 16c's hub model: DINOv2 ViT-B/14's parameter names and shapes
    (86,580,480 parameters) and a (91, 137) token grid for a 644 x 966
    input at stride 7 through the port's extractor (by shape arithmetic,
    the pos-embed interpolation at that size, and a forward at a small
    input); loaded through _load_model from the torch.hub directory, with
    the directory restored after."""
    import importlib.util

    from emernerf_torch.tools import extract_features as xf
    from emernerf_torch.tools.vit_extractor import ViTFeatureExtractor

    path = chip_smoke.write_hubconf(str(tmp_path), **chip_smoke.DINOV2_VITB14)
    spec = importlib.util.spec_from_file_location("vitb14_hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with torch.device("meta"):
        shapes = {k: tuple(p.shape) for k, p in mod.dinov2_vitb14().named_parameters()}
    block = {"norm1.weight": (768,), "norm1.bias": (768,), "attn.qkv.weight": (2304, 768),
             "attn.qkv.bias": (2304,), "attn.proj.weight": (768, 768), "attn.proj.bias": (768,),
             "ls1.gamma": (768,), "norm2.weight": (768,), "norm2.bias": (768,),
             "mlp.fc1.weight": (3072, 768), "mlp.fc1.bias": (3072,),
             "mlp.fc2.weight": (768, 3072), "mlp.fc2.bias": (768,), "ls2.gamma": (768,)}
    want = {"cls_token": (1, 1, 768), "mask_token": (1, 768), "pos_embed": (1, 1370, 768),
            "patch_embed.proj.weight": (768, 3, 14, 14), "patch_embed.proj.bias": (768,),
            "norm.weight": (768,), "norm.bias": (768,),
            **{f"blocks.{i}.{k}": v for i in range(12) for k, v in block.items()}}
    assert shapes == want
    assert sum(int(np.prod(s)) for s in shapes.values()) == 86_580_480

    old = torch.hub.get_dir()
    torch.hub.set_dir(str(tmp_path))
    try:
        model, _, kind = xf._load_model("dinov2_vitb14", None, "cpu")
    finally:
        torch.hub.set_dir(old)
    assert kind == "hub" and torch.hub.get_dir() == old
    ex = ViTFeatureExtractor(model, "dinov2_vitb14", stride=7, device="cpu")
    assert ex.num_patches(*chip_smoke.EXTRACT_HW) == chip_smoke.WAYMO_FEAT[:2] == (91, 137)
    # the forward passes (height, width) as (w, h), as DINOv2's does
    pe = model.interpolate_pos_encoding(torch.zeros(1, 1 + 91 * 137, 768), *chip_smoke.EXTRACT_HW)
    assert pe.shape == (1, 1 + 91 * 137, 768)
    x = torch.randn(1, 3, 42, 56, generator=torch.Generator().manual_seed(0))
    feat = ex.extract(x, layer=11, facet="key")
    assert feat.shape == (1, 5, 7, 768) and torch.isfinite(feat).all()


def test_phase_17_counts_k11_on_the_explicit_path_and_not_k8():
    """Phase 17a's launch check: the explicit data-parallel step launches
    K1-K3, K5 and K11's three entry points, and neither K8 (the implicit
    path's update) nor K4; phase 17c's rows report those launches ("dp")."""
    import inspect

    from emernerf_torch.train import optim

    counted, zero = chip_smoke._dp_counted()
    names = {fn.__name__ for fn in counted}
    assert {"spmd_adam_update", "zero_slab_update", "apply_direction", "brickgrid_encode",
            "brickgrid_encode_bwd", "importance_sampling", "composite_along_rays",
            "interlevel_loss_levels"} <= names
    assert optim.adam_update in zero and not names & {fn.__name__ for fn in zero}
    assert all(isinstance(fn.launches, int) for fn in counted + zero)
    main = inspect.getsource(chip_smoke.main)
    assert main.index("phase_raw(") < main.index("phase_data_parallel(") < main.index(
        "phase_dp_kernels(") < main.index("kernel_only(")
    assert '"dp": dp["launches"]' in main
    src = inspect.getsource(chip_smoke.phase_dp_kernels)
    for fn in ("spmd_adam_update", "zero_slab_update", "apply_direction"):
        assert f'"adam.cu", ' in src and fn in src
    # the replicated update takes a group's leaves in one call, and 17a
    # holds it to 4 launches per iteration (one per group and branch)
    assert "spmd_adam_update([ps[i] for i in part]" in src
    assert "rep > 4 * n_it" in inspect.getsource(chip_smoke.phase_data_parallel)


def test_phase_17_runs_two_ranks_of_the_flagship_at_its_batch():
    """The ranks split the flagship's 8,192-ray batch (4,096 + 4,096 each)
    and its 16,384-ray eval chunk; the explicit run is 6 iterations."""
    from emernerf_torch.flagship import flagship_config
    from emernerf_torch.train.trainer import check_parallel, spmd_config

    cfg = flagship_config(overrides=[f"parallel.num_devices={chip_smoke.N_DP}"])
    assert chip_smoke.N_DP == 2 and cfg.data.ray_batch_size // chip_smoke.N_DP == 4096
    check_parallel(cfg, chip_smoke.N_DP)
    s = spmd_config(cfg)
    assert (s.zero, s.grad_psum_dtype, s.direction_dtype) == (True, "bfloat16", "bfloat16")
    assert chip_smoke.N_DP_WARMUP + chip_smoke.N_DP_TIMED == 6


def test_phase_18_runs_after_17c_and_before_the_kernel_times():
    import inspect

    main = inspect.getsource(chip_smoke.main)
    assert main.index("phase_dp_kernels(") < main.index("phase_grad_drift(") < main.index(
        "kernel_only(")


def test_sum_order_bound_holds_two_orders_of_a_hand_made_sum():
    """1 + 2^-24 + 2^-24 in fp32: left to right each small term rounds away
    (ties to even), right to left they add to 2^-23 first and survive; the
    two differ by 2^-23, within 2 (k - 1) u / (1 - (k - 1) u) * sum|terms|."""
    terms = np.array([1.0, 2.0 ** -24, 2.0 ** -24], dtype=np.float32)
    left = (terms[0] + terms[1]) + terms[2]
    right = terms[0] + (terms[1] + terms[2])
    diff = abs(float(right) - float(left))
    assert diff == 2.0 ** -23
    bound = float(chip_smoke.sum_order_bound(3, np.abs(terms.astype(np.float64)).sum()))
    assert diff <= bound < 2.1 * diff  # 4 u (1 + 2^-23) / (1 - 2 u): tight here
    assert float(chip_smoke.sum_order_bound(1, 5.0)) == 0.0
    k = torch.tensor([0, 1, 2, 1001])
    out = chip_smoke.sum_order_bound(k, torch.full((4,), 3.0))
    assert out[0] == out[1] == 0.0 and out[3] > 999 * out[2]


@pytest.mark.parametrize("dims,time_pair", [(3, False), (4, True), (4, False)])
def test_k1_term_counts_are_the_plain_backwards_terms(dims, time_pair):
    """Per table element, the count of w * g terms K1 backward adds: every
    element the plain backward writes has one (all weights > 0 inside the
    cells), and the counts sum to points x levels x 8 corners x time slices
    x F."""
    from emernerf_torch.ops.brickgrid import BrickGridSpec, brickgrid_encode_bwd_ref

    spec = BrickGridSpec(n_input_dims=dims, n_levels=3, base_resolution=4, max_resolution=16,
                         log2_bricks=6, n_features_per_level=2, time_pair=time_pair)
    g = torch.Generator().manual_seed(5)
    pos = torch.rand((200, dims), generator=g) * 0.9 + 0.05
    table = torch.rand(spec.table_shape, generator=g)
    grad = torch.rand((200, spec.n_output_dims), generator=g) + 0.1
    d_table, _ = brickgrid_encode_bwd_ref(table, pos, grad, spec, False)
    counts = chip_smoke.k1_term_counts(pos, spec)
    assert counts.shape == d_table.shape
    slices = 2 if dims == 4 else 1
    assert int(counts.sum()) == 200 * spec.n_levels * 8 * slices * spec.n_features_per_level
    assert torch.equal(counts > 0, d_table != 0)
