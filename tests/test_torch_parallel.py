"""Data parallelism of the port (``emernerf_torch/parallel``) on the CPU:
two ranks spawned with ``torch.multiprocessing`` on gloo, rendezvousing on
a file under the test's temporary directory (xdist workers never share a
port).  One spawn runs every scenario (``_rank``) and saves each rank's
results; the tests below hold them against

- the JAX package's ``reduce_grads`` + ``spmd_apply_update`` under a
  ``shard_map`` over 2 of the conftest's virtual CPU devices, on a toy tree
  (leaves above and below ``zero_min_elems``, a leading dim that does not
  divide by 2, a bf16-moment leaf, and a Linear weight that the port stores
  transposed, routed by its JAX shape);
- a one-process emulation of the explicit step (the port's step on each
  half batch with its slice of the draws, the gradients averaged, the plain
  K11 update), ZeRO against replicated, bf16 wire against fp32;
- the single-process step (the implicit path, the masked depth loss and the
  line-of-sight loss active);
- the single-process eval render, bit for bit;
- a ZeRO checkpoint read back by one process, a stop signal on one rank,
  the refusals of indivisible sizes; and the CLI starting its own ranks.
"""

import dataclasses
import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import Mesh, PartitionSpec as P

from emernerf_torch.flagship import build_flagship, flagship_config, flagship_flow_spec
from emernerf_torch.parallel import mesh
from emernerf_torch.parallel import spmd as tspmd
from emernerf_torch.train import trainer as trainer_mod
from emernerf_torch.train.optim import AdamState, make_adam, spmd_adam_update_ref
from emernerf_torch.train.step import StepDraws
from emernerf_torch.train.trainer import Trainer
from emernerf_tpu.parallel import spmd as jspmd
from emernerf_tpu.train import optim as joptim

N = 2
LR, WD, COUNT = 3e-3, 1e-5, 3
TOY_MIN = 256  # zero_min_elems of the toy tree
TINY_MIN = 1 << 10  # the tiny flagship's tables through the ZeRO routing
# the toy tree: name -> (JAX shape, transposed in the port)
TOY = {"table": ((2048, 512), False),  # >= 2^20: bf16 moments, ZeRO-routed
       "big": ((8, 64), False),  # routed
       "odd": ((9, 40), False),  # >= TOY_MIN, 9 rows: replicated
       "small": ((5, 7), False),  # replicated
       "linear": ((16, 33), True),  # JAX (in, out): routed by its 16 rows, not the port's 33
       "bias": ((33,), False)}
WIRES = [(w, z, d) for w in ("float32", "bfloat16") for z in (False, True)
         for d in ("float32", "bfloat16")]
TIMEOUT = 240  # seconds for the spawned ranks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_inputs():
    """numpy: params (JAX layout), per-rank grads, moments (storage dtypes)."""
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) for k, (s, _) in TOY.items()}
    grads = [{k: (rng.normal(size=s) * 1e-2).astype(np.float32) for k, (s, _) in TOY.items()}
             for _ in range(N)]
    mu = {k: (rng.normal(size=s) * 1e-3).astype(np.float32) for k, (s, _) in TOY.items()}
    nu = {k: (rng.uniform(size=s) * 1e-4).astype(np.float32) for k, (s, _) in TOY.items()}
    return params, grads, mu, nu


def _bf16_moments(k):
    return np.prod(TOY[k][0]) >= joptim._BF16_MOMENT_MIN_ELEMS


def _port(a, k):
    """A JAX-layout array in the port's layout."""
    return a.T if TOY[k][1] else a


# ---------------------------------------------------------------- ranks
def _spmd_toy(rank, group):
    """The port's reduce_grads + spmd_apply_update on the toy tree, for every
    wire setting: params and whole moments after one step (port layout)."""
    names = list(TOY)
    out = {}
    for wire, zero, direction in WIRES:
        params, grads, mu, nu = _toy_inputs()  # updated in place below
        cfg = tspmd.SpmdConfig(grad_psum_dtype=wire, zero=zero, direction_dtype=direction,
                               zero_min_elems=TOY_MIN)
        ps = [torch.from_numpy(np.ascontiguousarray(_port(params[k], k))) for k in names]
        gs = [torch.from_numpy(np.ascontiguousarray(_port(grads[rank][k], k))) for k in names]
        dt = [torch.bfloat16 if _bf16_moments(k) else torch.float32 for k in names]
        adam = AdamState(COUNT, [torch.from_numpy(np.ascontiguousarray(_port(mu[k], k))).to(d)
                                 for k, d in zip(names, dt)],
                         [torch.from_numpy(np.ascontiguousarray(_port(nu[k], k))).to(d)
                          for k, d in zip(names, dt)])
        route = tspmd.routing(ps, [TOY[k][1] for k in names], cfg, N)
        tspmd.shard_moments(adam, route, rank, N)
        red = tspmd.reduce_grads(ps, gs, route.big, cfg.wire_dtype, group)
        tspmd.spmd_apply_update(red, adam, ps, LR, route, cfg, group, make_adam(WD))
        whole = tspmd.gather_moments(adam, route, group)
        out[(wire, zero, direction)] = dict(
            big=route.big, params=[_np(p) for p in ps],
            mu=[_np(m) for m in whole.mu], nu=[_np(v) for v in whole.nu],
            shard_rows=[m.shape[0] for m in adam.mu])
    return out


def _tiny_cfg(overrides=()):
    return flagship_config(tiny=True, overrides=["parallel.num_devices=2", *overrides])


def _trainer(group, spmd=None, overrides=(), log_dir=None):
    """A tiny-flagship rank; ``spmd`` replaces parallel.*'s settings (for
    the ZeRO routing of the tiny tables)."""
    cfg = _tiny_cfg(overrides)
    orig = trainer_mod.spmd_config
    if spmd is not None:
        trainer_mod.spmd_config = lambda c: spmd
    try:
        return Trainer(cfg, log_dir, device="cpu", flow=flagship_flow_spec(cfg, tiny=True),
                       group=group)
    finally:
        trainer_mod.spmd_config = orig


def _np(t):
    """A float32 numpy copy (a result must not share a tensor's memory)."""
    return t.detach().float().numpy().copy()


def _snapshot(t):
    return [_np(p) for p in t.state.params + t.state.prop_params]


def _steps(group, spmd, n=2):
    t = _trainer(group, spmd)
    metrics = [{k: float(v) for k, v in t.train_iteration(s).items()} for s in range(n)]
    return dict(params=_snapshot(t), metrics=metrics,
                routed=None if t.state.zero is None else sum(t.state.zero.model.big),
                shard_rows=[m.shape[0] for m in t.state.opt_state.mu])


def _rank(rank, init, out_dir):
    torch.set_num_threads(1)
    group, device = mesh.init_data_parallel(N, "cpu", init_method=init, rank=rank)
    assert device == torch.device("cpu") and dist.get_backend(group) == "gloo"
    res = {"toy": _spmd_toy(rank, group)}

    def cfg(wire, zero):
        return tspmd.SpmdConfig(grad_psum_dtype=wire, zero=zero, direction_dtype=wire,
                                zero_min_elems=TINY_MIN)

    res["zero_f32"] = _steps(group, cfg("float32", True))
    res["rep_f32"] = _steps(group, cfg("float32", False))
    res["zero_bf16"] = _steps(group, cfg("bfloat16", True))
    implicit = _masked(_trainer(group, overrides=IMPLICIT))
    res["implicit"] = [{k: float(v) for k, v in implicit.train_iteration(s).items()}
                       for s in range(2)]
    res["render"] = _render(group, 32)
    try:
        _render(group, 33)
    except ValueError as e:
        res["render_33"] = str(e)
    # an indivisible batch raises before the dataset is built
    built = trainer_mod.build_dataset_from_cfg
    trainer_mod.build_dataset_from_cfg = lambda *a, **k: 1 / 0  # built: ZeroDivisionError
    try:
        _trainer(group, overrides=["data.ray_batch_size=63"])
    except ValueError as e:
        res["batch_63"] = str(e)
    finally:
        trainer_mod.build_dataset_from_cfg = built
    # a ZeRO checkpoint
    os.makedirs(os.path.join(out_dir, "ckpt"), exist_ok=True)
    t = _trainer(group, cfg("float32", True), overrides=["optim.num_iters=2"],
                 log_dir=os.path.join(out_dir, "ckpt"))
    t.train()
    whole = tspmd.gather_moments(t.state.opt_state, t.state.zero.model, group)
    res["ckpt"] = dict(step=t.state.step, mu=[_np(m) for m in whole.mu],
                       nu=[_np(v) for v in whole.nu],
                       shard_rows=[m.shape[0] for m in t.state.opt_state.mu])
    # SIGTERM to rank 1 during iteration 2: both ranks stop after it
    t = _trainer(group, overrides=["optim.num_iters=6"])
    step_fn = t.train_iteration

    def signalled(step):
        if rank == 1 and step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step_fn(step)

    t.train_iteration = signalled
    t.train()
    res["stop"] = (t.preempted, t.state.step)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# the implicit path with the line-of-sight loss on from step 1 ...
IMPLICIT = ["parallel.explicit_collectives=false", "supervision.depth.line_of_sight.start_iter=0"]


def _masked(t):
    """... and the depth loss masked: the synthetic scene's returns lie at
    7-74 m, so an upper bound of 12.7 m (about their median) leaves a
    different valid count in each half batch."""
    t.train_step.cfg = dataclasses.replace(t.train_step.cfg, depth_upper_bound=12.7)
    return t


def _render(group, chunk):
    """A tiny-flagship eval render of 50 rays in chunks of ``chunk``."""
    _, _, model, props, _ = build_flagship(tiny=True, device="cpu")
    from emernerf_torch.eval.renderer import ImageRenderer

    r = ImageRenderer(model, props, num_samples=4, prop_samples=(8, 4), chunk_size=chunk,
                      return_decomposition=True, device="cpu", group=group)
    return r.render_rays_chunked(_render_rays())


def _render_rays():
    rng = np.random.default_rng(3)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    return {"origins": rng.normal(size=(50, 3)).astype(np.float32),
            "viewdirs": d / np.linalg.norm(d, axis=-1, keepdims=True),
            "normed_timestamps": rng.uniform(size=50).astype(np.float32)}


def spawn(fn, tmp, *args):
    """Run ``fn(rank, init_method, *args)`` on N spawned ranks; fails on a
    rank's error or after TIMEOUT seconds."""
    init = "file://" + os.path.join(str(tmp), "rendezvous")
    ctx = mp.start_processes(fn, args=(init, *args), nprocs=N, join=False,
                             start_method="spawn")
    t0 = time.monotonic()
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() - t0 > TIMEOUT:
                pytest.fail(f"the spawned ranks ran past {TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """The directory of the spawned ranks' results and files."""
    tmp = tmp_path_factory.mktemp("ranks")
    spawn(_rank, tmp, str(tmp))
    return tmp


@pytest.fixture(scope="module")
def ranks(run_dir):
    return [torch.load(run_dir / f"rank{r}.pt", weights_only=False) for r in range(N)]


# ---------------------------------------------------------------- JAX
def _jax_toy(wire, zero, direction):
    params, grads, mu, nu = _toy_inputs()
    cfg = jspmd.SpmdConfig(grad_psum_dtype=wire, zero=zero, direction_dtype=direction,
                           zero_min_elems=TOY_MIN)
    tx = joptim.make_adam(WD)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    wd_state, adam = tx.init(jp)
    adam = adam._replace(count=jnp.asarray(COUNT, jnp.int32),
                         mu={k: jnp.asarray(mu[k]).astype(adam.mu[k].dtype) for k in TOY},
                         nu={k: jnp.asarray(nu[k]).astype(adam.nu[k].dtype) for k in TOY})
    state = (wd_state, adam)
    specs = jax.tree.map(lambda x: P("data") if zero and jspmd._is_big(x, N, TOY_MIN) else P(),
                         state)
    stacked = {k: jnp.stack([jnp.asarray(g[k]) for g in grads]) for k in TOY}
    devices = np.array(jax.devices()[:N])

    def step(g, o, p):
        g = jspmd.reduce_grads(jax.tree.map(lambda x: x[0], g), cfg, N)
        return jspmd.spmd_apply_update(g, o, p, LR, cfg, N, WD)

    fn = jax.shard_map(step, mesh=Mesh(devices, ("data",)), in_specs=(P("data"), specs, P()),
                       out_specs=(P(), specs), check_vma=False)
    new_p, (_, new_adam) = jax.jit(fn)(stacked, state, jp)
    return ({k: np.asarray(new_p[k]) for k in TOY},
            {k: np.asarray(new_adam.mu[k].astype(jnp.float32)) for k in TOY},
            {k: np.asarray(new_adam.nu[k].astype(jnp.float32)) for k in TOY})


@pytest.mark.parametrize("wire,zero,direction", WIRES)
def test_spmd_primitives_match_jax(ranks, wire, zero, direction):
    """Params and moments after one step of each package's reduce_grads +
    spmd_apply_update on the same per-rank gradients.  fp32 wire: rtol
    1e-6 and an atol of 1e-6 of the leaf's largest |value| (an fp32 ulp of
    the update where a param lands near zero); a moment stored in bf16
    within one bf16 ulp (2^-7 relative: the fp32 value before the rounding
    may differ in its last bit).  bf16 wire: the gradient mean is summed in bf16 in another order
    by gloo and by XLA, so a param may differ by one bf16 ulp of the
    direction times lr (2^-7 |dir| lr, the direction read from JAX's step)
    and the moments by one bf16 ulp of themselves (2^-7 relative) plus
    the gradient's share of a bf16 ulp."""
    res = [r["toy"][(wire, zero, direction)] for r in ranks]
    jp, jmu, jnu = _jax_toy(wire, zero, direction)
    params = _toy_inputs()[0]
    names = list(TOY)
    # routing by the JAX shape: the Linear weight is routed, the 9-row leaf not
    assert res[0]["big"] == tuple(zero and k in ("table", "big", "linear") for k in names)
    for i, k in enumerate(names):
        rows = TOY[k][0][0] // (N if res[0]["big"][i] else 1)
        assert res[0]["shard_rows"][i] == (rows if res[0]["big"][i] else
                                          _port(params[k], k).shape[0])
        for r in res:
            np.testing.assert_array_equal(r["params"][i], res[0]["params"][i])
        ours = {"p": res[0]["params"][i], "mu": res[0]["mu"][i], "nu": res[0]["nu"][i]}
        ref = {"p": _port(jp[k], k), "mu": _port(jmu[k], k), "nu": _port(jnu[k], k)}
        if wire == "float32":
            for what in ours:
                # a moment stored in bf16 may round the other way where the
                # two fp32 values differ in their last bit: one bf16 ulp
                rtol = 2.0 ** -7 if what != "p" and _bf16_moments(k) else 1e-6
                np.testing.assert_allclose(ours[what], ref[what], rtol=rtol,
                                           atol=1e-6 * np.abs(ref[what]).max(),
                                           err_msg=f"{k} {what}")
            continue
        direction_ref = np.abs(_port(params[k], k) - ref["p"]) / LR
        bound = LR * 2.0 ** -7 * direction_ref + 1e-6 * np.abs(ref["p"])
        assert np.all(np.abs(ours["p"] - ref["p"]) <= bound), k
        for what in ("mu", "nu"):
            tol = 2.0 ** -7 * np.abs(ref[what]) + 2.0 ** -7 * np.abs(ref[what]).max()
            assert np.all(np.abs(ours[what] - ref[what]) <= tol), (k, what)


# ---------------------------------------------------------------- the step
class _Emulated:
    """N ranks of the explicit step in one process: each branch's loss and
    backward on each half batch with its slice of the draws, the gradients
    averaged (a sum, then / N), then the plain K11 update of every leaf."""

    def __init__(self, step):
        self.step = step
        self.render_kw = step.render_kw

    @staticmethod
    def _half(x, r):
        return None if x is None else mesh.batch_slice(x, r, N)

    def _draws(self, d, r):
        return StepDraws(tuple(self._half(j, r) for j in d.jitters), self._half(d.topk_u, r),
                         self._half(d.agg_noise, r))

    def _branch(self, state, loss_fn, batch, draws, rg, count):
        parts = ([(state.prop_params, state.prop_opt_state)] if rg else []) + [
            (state.params, state.opt_state)]
        ps = [p for part, _ in parts for p in part]
        acc = [torch.zeros_like(p) for p in ps]
        for r in range(N):
            total, _ = loss_fn({k: self._half(v, r) for k, v in batch.items()},
                               self._draws(draws, r), state.step, rg)
            total.backward()
            for a, p in zip(acc, ps):
                if p.grad is not None:
                    a += p.grad
                p.grad = None
        for p in state.params + state.prop_params:
            p.grad = None
        lr = self.step.lr_fn(count)
        i = 0
        for part, opt in parts:
            opt.count += 1
            h = self.step.tx.hyper(opt.count, lr)
            for p, m, v in zip(part, opt.mu, opt.nu):
                with torch.no_grad():
                    spmd_adam_update_ref(p, acc[i] / N, m, v, h)
                i += 1

    def __call__(self, state, pixel_batch, lidar_batch, pixel_draws, lidar_draws, pixel_rg,
                 lidar_rg, lidar_full=False):
        count = state.step * self.step.steps_per_iter
        self._branch(state, self.step.pixel_loss, pixel_batch, pixel_draws, pixel_rg, count)
        self._branch(state, lambda b, d, s, rg: self.step.lidar_loss(b, d, s, rg, lidar_full),
                     lidar_batch, lidar_draws, lidar_rg, count + 1)
        state.step += 1
        return {}


def _single(overrides=()):
    cfg = flagship_config(tiny=True, overrides=list(overrides))
    return Trainer(cfg, device="cpu", flow=flagship_flow_spec(cfg, tiny=True))


def _max_rel(a, b):
    return max(float(np.max(np.abs(x - y) / np.maximum(np.abs(x), 1e-3))) for x, y in zip(a, b))


@pytest.mark.parametrize("run", ["zero_f32", "rep_f32"])
def test_explicit_step_matches_its_one_process_emulation(ranks, run):
    """Two iterations of the explicit step, fp32 wire: every param within
    rtol 1e-5 of the emulation (the same per-half losses; only the sum's
    and the reduce-scatter's order of operations differ)."""
    res = [r[run] for r in ranks]
    emulated = _single()
    emulated.train_step = _Emulated(emulated.train_step)
    for s in range(2):
        emulated.train_iteration(s)
    np.testing.assert_array_equal(np.concatenate([p.ravel() for p in res[0]["params"]]),
                                  np.concatenate([p.ravel() for p in res[1]["params"]]))
    for ours, ref in zip(res[0]["params"], _snapshot(emulated)):
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)
    if run == "zero_f32":
        assert res[0]["routed"] > 0
        full = [p.shape[0] for p in emulated.state.opt_state.mu]
        assert sorted(set(res[0]["shard_rows"]) - set(full))  # some moments hold half the rows


def test_zero_matches_replicated_and_bf16_stays_near_fp32(ranks):
    """ZeRO at fp32 against replicated at fp32 within 1e-4 (mirror of
    tests/test_spmd.py:75); the bf16 wire within 5e-2 of fp32 (mirror of
    :107), both after 2 iterations; finite metrics."""
    res = ranks[0]
    assert _max_rel(res["zero_f32"]["params"], res["rep_f32"]["params"]) < 1e-4
    assert _max_rel(res["zero_f32"]["params"], res["zero_bf16"]["params"]) < 5e-2
    for run in ("zero_f32", "rep_f32", "zero_bf16"):
        assert all(np.isfinite(v) for m in res[run]["metrics"] for v in m.values())


def test_implicit_step_matches_the_single_process_step(ranks):
    """The implicit path's losses and metrics equal the one-process step's
    on the whole batch (rtol 1e-4, atol 1e-5, as tests/test_parallel.py:138)
    over two iterations, with the masked depth loss and the line-of-sight
    loss on; both ranks report the same."""
    res = [r["implicit"] for r in ranks]
    single = _masked(_single(IMPLICIT))
    ref = [{k: float(v) for k, v in single.train_iteration(s).items()} for s in range(2)]
    assert ref[1]["lidar_line_of_sight"] > 0
    for ours, other, theirs in zip(res[0], res[1], ref):
        assert ours == other
        for k, v in theirs.items():
            np.testing.assert_allclose(ours[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_implicit_step_needs_the_whole_batch_denominators(ranks):
    """The split batch really separates the per-rank and the whole-batch
    valid counts: the halves' depth losses averaged are not the whole
    batch's."""
    from emernerf_torch.losses.losses import depth_loss

    g = torch.Generator().manual_seed(0)
    pred = torch.rand(64, 1, generator=g) * 60
    gt = torch.cat([torch.rand(32, generator=g) * 30, torch.rand(32, generator=g) * 60 + 30])
    whole = depth_loss(pred, gt, max_depth=40.0)
    halves = [depth_loss(pred[i * 32:(i + 1) * 32], gt[i * 32:(i + 1) * 32], max_depth=40.0)
              for i in range(2)]
    count = ((gt > 0.01) & (gt < 40.0)).float().sum()
    global_den = [depth_loss(pred[i * 32:(i + 1) * 32], gt[i * 32:(i + 1) * 32], max_depth=40.0,
                             denominator=count / 2) for i in range(2)]
    assert abs(float(sum(halves) / 2 - whole)) > 1e-3
    np.testing.assert_allclose(float(sum(global_den) / 2), float(whole), rtol=1e-6)


def test_sharded_eval_render_equals_the_single_render(ranks):
    """Each rank renders half of every 32-ray chunk of 50 rays (the last
    padded); the gathered outputs equal the one-process render bit for bit
    on both ranks; a chunk of 33 does not split over 2 ranks and raises."""
    _, _, model, props, _ = build_flagship(tiny=True, device="cpu")
    from emernerf_torch.eval.renderer import ImageRenderer

    ref = ImageRenderer(model, props, num_samples=4, prop_samples=(8, 4), chunk_size=32,
                        return_decomposition=True, device="cpu").render_rays_chunked(
        _render_rays())
    for r in ranks:
        out = r["render"]
        assert set(out) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
        assert "not divisible" in r["render_33"]


def test_trainer_refuses_an_indivisible_batch_before_the_dataset(ranks):
    for r in ranks:
        assert "data.ray_batch_size 63 must divide" in r["batch_63"]
    with pytest.raises(ValueError, match="process group"):
        Trainer(_tiny_cfg(), device="cpu")


def test_zero_checkpoint_resumes_in_one_process(ranks, run_dir):
    """The 2-rank ZeRO run's final checkpoint holds whole moments: a 1-rank
    trainer loads it at the same step with the same moments and params."""
    tmp = run_dir
    ck = ranks[0]["ckpt"]
    assert "checkpoint_00003" in os.listdir(tmp / "ckpt")
    one = Trainer(flagship_config(tiny=True, overrides=[
        f"resume_from={tmp / 'ckpt' / 'checkpoint_00003'}"]), device="cpu",
        flow=flagship_flow_spec(flagship_config(tiny=True), tiny=True))
    assert one.start_step == ck["step"] == 3
    assert any(r < f for r, f in zip(ck["shard_rows"], (m.shape[0] for m in one.state.opt_state.mu)))
    for ours, theirs in zip(one.state.opt_state.mu + one.state.opt_state.nu, ck["mu"] + ck["nu"]):
        np.testing.assert_array_equal(ours.float().numpy(), theirs)
    for line in open(tmp / "ckpt" / "metrics.json"):
        assert np.isfinite(json.loads(line)["rgb_loss"])


def test_a_signal_on_one_rank_stops_every_rank_at_the_same_step(ranks):
    res = [r["stop"] for r in ranks]
    assert res[0] == res[1] == (True, 3)


def test_world_size_and_rank_devices():
    assert mesh.world_size(3, "cpu") == 3
    with pytest.raises(ValueError, match="needs device 'cuda'"):
        mesh.world_size(0, "cpu")
    with pytest.raises(ValueError, match="GPUs"):
        mesh.world_size(1 + torch.cuda.device_count(), "cuda")
    assert mesh.rank_device("cuda", 1) == torch.device("cuda", 1)
    assert mesh.rank_device("cuda:0", 1) == torch.device("cuda", 0)
    assert mesh.rank_device("cpu", 1) == torch.device("cpu")
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(mesh.batch_slice(x, 1, 3), x[2:4])
    with pytest.raises(ValueError):
        mesh.batch_slice(x, 0, 4)


def test_trainer_counts_ranks_as_the_mesh_does():
    """``parallel.num_devices`` means to ``Trainer`` what it means to
    ``mesh.world_size``: 0 (every visible GPU) raises on the CPU."""
    with pytest.raises(ValueError, match="needs device 'cuda'"):
        Trainer(_tiny_cfg(["parallel.num_devices=0"]), device="cpu")


def _cli_argv(root, run_name):
    from test_cli import TINY_OVERRIDES

    return ["--device", "cpu", "--output_root", str(root), "--project", "p", "--run_name",
            run_name, *TINY_OVERRIDES, "parallel.num_devices=2", "optim.num_iters=2",
            "logging.print_freq=1", "render.render_low_res=false"]


@pytest.fixture(scope="module")
def spawned_cli_run(tmp_path_factory):
    """The run directory of the CLI that starts its own two ranks."""
    from emernerf_torch.train_emernerf import main

    root = tmp_path_factory.mktemp("cli")
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setenv("OMP_NUM_THREADS", "1")
        mp_.delenv("WORLD_SIZE", raising=False)
        assert main(_cli_argv(root, "dp")) is None
    return root / "p" / "dp"


def _metrics(run):
    """metrics.json's records without their clock readings."""
    return [{k: v for k, v in json.loads(line).items() if not k.endswith("_time")}
            for line in (run / "metrics.json").read_text().splitlines()]


def test_cli_starts_two_ranks_and_rank_0_writes(spawned_cli_run):
    """``parallel.num_devices=2 --device cpu``: the CLI spawns two ranks that
    train 2 iterations; one metrics.json, one final checkpoint."""
    run = spawned_cli_run
    lines = (run / "metrics.json").read_text().splitlines()
    assert len(lines) == 3 and all(np.isfinite(json.loads(x)["rgb_loss"]) for x in lines)
    assert sorted(f.name for f in run.glob("checkpoint_*")) == ["checkpoint_00003"]
    assert (run / "metrics_all_3.json").exists()


def test_cli_under_torchrun_writes_what_the_spawned_ranks_write(spawned_cli_run, tmp_path):
    """The same run under ``torchrun --nproc_per_node 2`` (the ranks join
    the group from its environment): one metrics.json equal to the spawned
    run's but for its clock readings, one final checkpoint."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([repo, os.path.join(repo, "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           "-m", "emernerf_torch.train_emernerf", *_cli_argv(tmp_path, "torchrun")]
    proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out = proc.communicate(timeout=TIMEOUT)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"torchrun's ranks ran past {TIMEOUT} s")
    assert proc.returncode == 0, out[-3000:]
    run = tmp_path / "p" / "torchrun"
    assert _metrics(run) == _metrics(spawned_cli_run)
    assert sorted(f.name for f in run.glob("checkpoint_*")) == ["checkpoint_00003"]


def test_cli_under_torchrun_refuses_another_rank_count(tmp_path, monkeypatch):
    """torchrun's WORLD_SIZE must be parallel.num_devices."""
    from emernerf_torch.train_emernerf import main

    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="torchrun started 3 ranks, parallel.num_devices asks "
                                         "for 2"):
        main(_cli_argv(tmp_path, "mismatch"))
    assert not (tmp_path / "p").exists()
