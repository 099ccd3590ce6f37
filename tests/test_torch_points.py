"""Port parity of the point queries: ``RadianceField.query_flow`` and
``query_attributes`` through the port's ``PointQueryEngine`` against the JAX
package's ``PointQueryEngine`` (jitted, fixed 512-point chunks), on the CPU
in fp32, with the converted params of ``test_torch_fields._make_pair``
(grid tables scaled up from their init): the tiny flagship (brick grids,
the fused dynamic+flow grid), its reference-hash profile (hash grids,
separate dynamic and flow grids) and the dynamic-only profile (no flow,
``query_attributes`` only), at timestamps and without them (the static
density alone).

N = 1000 points, a quarter outside the aabb (the contraction) and one far
outside (zeroed encodings), go through the port in chunks of 256 and of
384 (N a multiple of neither).  Tolerance: rtol 1e-5, atol 1e-6 on every
output key.
"""

import numpy as np
import pytest
import torch
from test_torch_fields import _make_pair

from emernerf_tpu.eval.points import PointQueryEngine as JaxPointQueryEngine
from emernerf_torch.eval.points import PointQueryEngine
from emernerf_torch.flagship import DEFAULT_PROFILE, DYNAMIC, REFERENCE_HASH

N = 1000
JAX_CHUNK = 512
CHUNKS = (256, 384)
PROFILES = {"flagship": DEFAULT_PROFILE, "reference_hash": REFERENCE_HASH, "dynamic": DYNAMIC}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's parallel workers would oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    """The converted pair of each profile, built on first use."""
    built = {}

    def get(name):
        if name not in built:
            built[name] = _make_pair(PROFILES[name])
            built[name]["engine"] = JaxPointQueryEngine(built[name]["jmodel"], JAX_CHUNK)
        return built[name]

    return get


def _points(aabb, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = aabb[:3], aabb[3:]
    pos = rng.uniform(lo - 0.25 * (hi - lo), hi + 0.25 * (hi - lo), (N, 3))
    pos[0] = 1e4
    return pos.astype(np.float32), rng.uniform(0, 1, N).astype(np.float32)


CASES = [("flagship", "flow"), ("flagship", "attributes"), ("flagship", "static"),
         ("reference_hash", "flow"), ("reference_hash", "attributes"),
         ("reference_hash", "static"), ("dynamic", "attributes"), ("dynamic", "static")]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("profile,query", CASES, ids=[f"{p}-{q}" for p, q in CASES])
def test_point_query_matches_jax(pairs, profile, query, chunk):
    p = pairs(profile)
    pos, t = _points(p["dataset"].aabb)
    jax_engine, ours = p["engine"], PointQueryEngine(p["tmodel"], chunk, device="cpu")
    if query == "flow":
        ref, out = jax_engine.query_flow(p["params"], pos, t), ours.query_flow(pos, t)
    elif query == "attributes":
        ref, out = (jax_engine.query_attributes(p["params"], pos, t),
                    ours.query_attributes(pos, t))
    else:
        ref, out = jax_engine.query_attributes(p["params"], pos), ours.query_attributes(pos)
    assert set(out) == set(ref), (sorted(out), sorted(ref))
    for k in ref:
        assert out[k].shape == ref[k].shape and out[k].dtype == np.float32, k
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)
    if query != "static":
        assert np.ptp(out["dynamic_density"]) > 1e-3  # not a constant field
    if profile == "flagship":
        assert p["tmodel"].fused


@pytest.fixture(scope="module")
def flagship_dataset():
    """The port's tiny flagship scene (the JAX pair's dataset is the JAX
    package's)."""
    from emernerf_torch.builders import build_dataset_from_cfg
    from emernerf_torch.flagship import flagship_config

    return build_dataset_from_cfg(flagship_config(tiny=True))


@pytest.mark.parametrize("remove_ground", [True, False], ids=["no_ground", "with_ground"])
def test_lidar_flow_eval_matches_jax(pairs, flagship_dataset, remove_ground):
    """The NSFP protocol on the tiny synthetic scene (its analytic lidar
    flows): the five metrics within 1e-5 of JAX's."""
    from emernerf_tpu.eval.flow import evaluate_lidar_flow as jax_evaluate_lidar_flow
    from emernerf_torch.eval.flow import evaluate_lidar_flow

    p = pairs("flagship")
    for k in ("flows", "flow_classes", "ground", "frame_idx"):
        np.testing.assert_array_equal(flagship_dataset.lidar[k], p["dataset"].lidar[k], err_msg=k)
    ref = jax_evaluate_lidar_flow(p["engine"], p["params"], p["dataset"],
                                  remove_ground=remove_ground)
    ours = evaluate_lidar_flow(PointQueryEngine(p["tmodel"], CHUNKS[0], device="cpu"),
                               flagship_dataset, remove_ground=remove_ground)
    assert set(ours) == {"EPE3D", "acc3d_strict", "acc3d_relax", "angle_error", "outlier"}
    for k, v in ref.items():
        assert ours[k] == pytest.approx(v, rel=1e-5, abs=1e-5), k
    assert ours["EPE3D"] > 0


# density thresholds near the median density of the tiny scaled fields'
# voxel grids (static ~0.34-0.40, static + dynamic ~0.66-0.71)
@pytest.mark.parametrize("profile,timed,threshold", [
    ("flagship", True, 0.69), ("flagship", False, 0.37), ("reference_hash", True, 0.69)],
    ids=["flagship", "flagship_static", "reference_hash"])
def test_occupied_voxels_match_jax(pairs, profile, timed, threshold):
    """``extract_occupied_voxels`` keeps the same cells as JAX's, and some
    cells are empty and some occupied."""
    from emernerf_tpu.eval.voxel_vis import extract_occupied_voxels as jax_extract
    from emernerf_torch.eval.voxel_vis import extract_occupied_voxels

    p = pairs(profile)
    aabb = np.asarray(p["dataset"].aabb, np.float32)
    t = 0.5 if timed else None
    ref, _ = jax_extract(p["engine"], p["params"], aabb, 4.0, t, threshold)
    ours, feats = extract_occupied_voxels(PointQueryEngine(p["tmodel"], CHUNKS[1], device="cpu"),
                                          aabb, 4.0, t, threshold)
    n_cells = np.prod(np.maximum(((aabb[3:] - aabb[:3]) / 4.0).astype(int), 1))
    assert feats is None and 0 < len(ours) < n_cells, (len(ours), n_cells)
    np.testing.assert_array_equal(ours, ref)


def test_voxel_and_scene_flow_exports_match_jax(pairs, flagship_dataset, tmp_path):
    """``visualize_voxels`` (two timesteps, height colors without the feature
    head) and ``visualize_scene_flow`` (the camera-visible lidar returns)
    write the JAX package's arrays: coordinates and colors exactly, the
    predicted flows within the queries' tolerance."""
    from emernerf_tpu.eval import voxel_vis as jax_voxel_vis
    from emernerf_torch.eval import voxel_vis

    p = pairs("flagship")
    engine = PointQueryEngine(p["tmodel"], CHUNKS[1], device="cpu")
    aabb = p["dataset"].aabb
    ours = voxel_vis.visualize_voxels(engine, aabb, str(tmp_path / "ours" / "voxels"),
                                      timesteps=[0.0, 0.5], voxel_size=4.0,
                                      density_threshold=0.69)
    ref = jax_voxel_vis.visualize_voxels(p["engine"], p["params"], aabb,
                                         str(tmp_path / "ref" / "voxels"),
                                         timesteps=[0.0, 0.5], voxel_size=4.0,
                                         density_threshold=0.69)
    a, b = np.load(ours), np.load(ref)
    assert set(a) == set(b) and len(a["frame1_xyz"]) > 0
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    html = (tmp_path / "ours" / "voxels.html").read_text()
    assert "frames: 2" in html and "B64DATA" not in html
    ours = voxel_vis.visualize_scene_flow(engine, flagship_dataset,
                                          str(tmp_path / "ours" / "flow.npz"))
    ref = jax_voxel_vis.visualize_scene_flow(p["engine"], p["params"], p["dataset"],
                                             str(tmp_path / "ref" / "flow.npz"))
    a, b = np.load(ours), np.load(ref)
    assert set(a) == set(b) and "frame2_pred_flow" in a
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6, err_msg=k)
