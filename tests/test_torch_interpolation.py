"""Port parity: the eval-time temporal interpolation of the flow field
(``RadianceField.forward_flow_hash`` and its routing in
``emernerf_torch/models/fields.py``) against ``emernerf_tpu/models/fields.py``
on the CPU in fp32 (rtol 1e-4, atol 1e-5), on the tiny flagship's fused
brick grid (with its top-K aggregation) and the reference-hash profile's
separate hash grids, lerping the encodings or the flow MLP's outputs
(``interpolate_xyz_encoding``): the eval forward, ``query_flow`` and
``query_attributes``, at a training timestep, off it, midway between two
(the tie of the two nearest) and past the last; ``find_topk_nearby_timesteps``
and its ties; the exact query at a training timestep; and training
queries (``train=True``), which never interpolate.  The model pairs are
``test_torch_fields``'s."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fields import _inputs, _make_pair

from emernerf_tpu.models.fields import find_topk_nearby_timesteps as jax_find_topk_nearby
from emernerf_torch.flagship import REFERENCE_HASH
from emernerf_torch.models.fields import find_topk_nearby_timesteps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in test_torch_fields."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return _make_pair()


@pytest.fixture(scope="module")
def hash_pair():
    return _make_pair(REFERENCE_HASH)

# normalized times against the tiny scene's training timesteps (0, 0.5, 1):
# on one, off the grid, midway between two (the nearest two tie) and past
# the last (the lerp's offset leaves [0, 1])
INTERP_TIMES = {"on_grid": 0.5, "off_grid": 0.3125, "midway": 0.25, "past_last": 1.25}
INTERP_CASES = [("pair", True), ("pair", False), ("hash_pair", True), ("hash_pair", False)]
INTERP_IDS = ["fused_brick-lerp_encodings", "fused_brick-lerp_outputs",
              "hash-lerp_encodings", "hash-lerp_outputs"]


@contextlib.contextmanager
def _interpolating(p, xyz):
    """The pair's models with temporal interpolation on (the JAX model a
    clone), lerping encodings (``xyz``) or flow MLP outputs."""
    tmodel = p["tmodel"]
    np.testing.assert_array_equal(tmodel.training_timesteps.numpy(),
                                  np.asarray(p["jmodel"].training_timesteps, np.float32))
    tmodel.enable_temporal_interpolation, tmodel.interpolate_xyz_encoding = True, xyz
    try:
        yield p["jmodel"].clone(enable_temporal_interpolation=True, interpolate_xyz_encoding=xyz)
    finally:
        tmodel.enable_temporal_interpolation, tmodel.interpolate_xyz_encoding = False, True


def _interp_inputs(p, seed):
    """Eval inputs whose rays cycle through INTERP_TIMES."""
    pos, dirs, data = _inputs(p["dataset"], seed=seed)
    times = np.resize(np.array(list(INTERP_TIMES.values()), np.float32), pos.shape[0])
    data["normed_timestamps"] = np.repeat(times[:, None], pos.shape[1], 1)
    return pos, dirs, data


def _torch_args(pos, dirs, data):
    return (torch.from_numpy(pos), torch.from_numpy(dirs),
            {k: torch.from_numpy(v) for k, v in data.items()})


def _assert_close(ours, ref):
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_training_timesteps_are_the_datasets(pair):
    ts = pair["tmodel"].training_timesteps.numpy()
    np.testing.assert_array_equal(ts, [0.0, 0.5, 1.0])
    np.testing.assert_array_equal(ts, pair["dataset"].unique_normalized_training_timestamps)


def test_find_topk_nearby_timesteps_matches_jax():
    """Nearest two, nearest first; ties (a query midway between two, and a
    repeated timestep) go to the lower index as jax.lax.top_k puts them."""
    rng = np.random.default_rng(0)
    for ts in (np.array([0.0, 0.25, 0.5, 0.75, 1.0], np.float32),
               np.array([0.5, 0.0, 0.5, 1.0, 0.125], np.float32),
               np.sort(rng.uniform(0, 1, 9)).astype(np.float32)):
        q = np.concatenate([[0.125, 0.375, 0.5, 0.0, 1.0, 1.5, -0.25],
                            rng.uniform(-0.1, 1.1, 33)]).astype(np.float32)
        for shape in ((40,), (5, 8), ()):
            qq = q[0] if shape == () else q.reshape(shape)
            ours = find_topk_nearby_timesteps(torch.from_numpy(ts), torch.as_tensor(qq))
            ref = np.asarray(jax_find_topk_nearby(ts, jnp.asarray(qq)))
            assert ours.shape == ref.shape == (*shape, 2)
            np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("name,xyz", INTERP_CASES, ids=INTERP_IDS)
def test_temporal_interpolation_forward_matches_jax(request, name, xyz):
    """The eval forward: the flow at every sample, the cycle predictions at
    the warped points (fused: the top-K aggregation's) and everything
    downstream, rays at each of INTERP_TIMES."""
    p = request.getfixturevalue(name)
    pos, dirs, data = _interp_inputs(p, 30)
    with _interpolating(p, xyz) as jm:
        ref = jax.jit(lambda prm, x, d, dd: jm.apply({"params": prm}, x, d, dd, train=False))(
            p["params"], pos, dirs, data)
        with torch.no_grad():
            ours = p["tmodel"](*_torch_args(pos, dirs, data), train=False)
    _assert_close(ours, ref)
    with torch.no_grad():
        exact = p["tmodel"](*_torch_args(pos, dirs, data))
    off = data["normed_timestamps"][:, 0] != INTERP_TIMES["on_grid"]
    assert not np.allclose(ours["forward_flow"].numpy()[off], exact["forward_flow"].numpy()[off])


@pytest.mark.parametrize("name,xyz", INTERP_CASES, ids=INTERP_IDS)
def test_temporal_interpolation_point_queries_match_jax(request, name, xyz):
    """query_flow and query_attributes (the flow eval's and the voxel
    export's queries) at each of INTERP_TIMES; a point batch takes its
    first point's time, as the reference does (the last batch)."""
    p = request.getfixturevalue(name)
    pos = _inputs(p["dataset"], seed=31)[0].reshape(-1, 3)
    rng = np.random.default_rng(31)
    batches = [np.full(len(pos), t, np.float32) for t in INTERP_TIMES.values()]
    batches.append(np.concatenate([[0.3125], rng.uniform(0, 1, len(pos) - 1)]).astype(np.float32))
    with _interpolating(p, xyz) as jm:
        jflow = jax.jit(lambda prm, x, t: jm.apply({"params": prm}, x, t, method="query_flow"))
        jattrs = jax.jit(lambda prm, x, t: jm.apply({"params": prm}, x, t,
                                                    method="query_attributes"))
        for t in batches:
            with torch.no_grad():
                flow = p["tmodel"].query_flow(torch.from_numpy(pos), torch.from_numpy(t))
                attrs = p["tmodel"].query_attributes(torch.from_numpy(pos), torch.from_numpy(t))
            _assert_close(flow, jflow(p["params"], pos, t))
            _assert_close(attrs, jattrs(p["params"], pos, t))


@pytest.mark.parametrize("name,xyz", INTERP_CASES, ids=INTERP_IDS)
def test_interpolation_at_a_training_timestep_is_the_exact_query(request, name, xyz):
    """At a training timestep the lerp's offset is 0: the flow, the
    densities and every output but the cycle predictions (at the warped
    times, off the grid) are bit for bit the exact query's."""
    p = request.getfixturevalue(name)
    pos, dirs, data = _inputs(p["dataset"], seed=32)
    data["normed_timestamps"][:] = INTERP_TIMES["on_grid"]
    args = _torch_args(pos, dirs, data)
    pts, t = args[0].reshape(-1, 3), torch.full((pos.shape[0] * pos.shape[1],), 0.5)
    with torch.no_grad():
        exact, exact_flow = p["tmodel"](*args), p["tmodel"].query_flow(pts, t)
        with _interpolating(p, xyz):
            ours, flow = p["tmodel"](*args), p["tmodel"].query_flow(pts, t)
    cycle = {"forward_pred_backward_flow", "backward_pred_forward_flow"}
    assert set(ours) == set(exact) and cycle <= set(ours)
    for k in set(exact) - cycle:
        assert torch.equal(ours[k], exact[k]), k
    for k in exact_flow:
        assert torch.equal(flow[k], exact_flow[k]), k


@pytest.mark.parametrize("name", ["pair", "hash_pair"], ids=["fused_brick", "hash"])
def test_training_queries_never_interpolate(request, name):
    """train=True (with the aggregation noise a training step draws) gives
    the query without interpolation bit for bit, where the eval query
    interpolates."""
    p = request.getfixturevalue(name)
    pos, dirs, data = _interp_inputs(p, 33)
    noise = torch.from_numpy(np.random.default_rng(33).uniform(
        0, 1, (*pos.shape[:2], 1)).astype(np.float32))
    args = _torch_args(pos, dirs, data)
    with torch.no_grad():
        plain = p["tmodel"](*args, agg_noise=noise, train=True)
        with _interpolating(p, True):
            trained = p["tmodel"](*args, agg_noise=noise, train=True)
            evaluated = p["tmodel"](*args, agg_noise=noise, train=False)
    for key in plain:
        assert torch.equal(trained[key], plain[key]), key
    assert not torch.equal(evaluated["forward_flow"], plain["forward_flow"])
