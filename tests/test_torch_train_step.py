"""Port parity for the training step: ``emernerf_tpu.train.step`` and
``emernerf_torch.train.step`` take the same iterations on the tiny flagship
on the CPU in fp32, from the same params, batches and random draws; and one
iteration of each of the tiny flagship's other profiles: reference-hash
(exact hash grids, separate dynamic and flow grids, every sample shaded and
flow-warped), reference-brick (the same on brick grids of unpaired 4D rows)
and dynamic-only (``configs/default_dynamic.yaml``: no flow, no cycle loss,
no aggregation noise drawn).

The draws: the jitted JAX step runs with ``jax.random.uniform`` wrapped,
in this test only, so that every draw it makes is passed out through a
debug callback in program order (per branch: three stratified jitters, the
top-K Gumbel uniforms, the aggregation noise where there is flow); the
port's ``StepDraws``
take the recorded arrays.  The gradients handed to ``apply_update`` are
recorded the same way on the JAX side and by wrapping ``apply_update`` on
the port's side.

The tiny flagship is widened so that top-K pruning (6 of 8 pixel samples,
4 lidar samples) and the top-2 temporal aggregation both run, with 32 and
16 proposal samples: with the tiny config's 8, every ray saturates inside
the first 50 m proposal interval, the first proposal net's gradient is
exponentially small and rounding noise dominates it.  Its tables are
scaled from U(+-1e-4) to U(+-0.2) so that densities vary along and across
rays.

Tolerances:
- losses rtol 1e-4; the sky loss rtol 1e-3: its BCE term log(1 - opacity)
  magnifies the ~1e-6 rounding of an opaque ray's opacity by
  1 / (1 - opacity);
- gradients per tensor: rtol 1e-3 and atol 2e-3 x the tensor's largest
  |grad| (JAX) (fp32 sums of up to 10^4 terms in another order, through
  exp/log that differ in the last ulp between XLA and PyTorch; the worst
  tensor measured 7.8e-4 at lr 1e-4).  The lidar branch runs on the params
  the pixel branch's Adam step has just moved, and Adam moves an element
  by about lr whatever the size of its gradient: where a rounding-level
  gradient has opposite signs in the two packages, the lidar branch's
  inputs differ by 2 lr.  After the lr-0.01 update of the LoS variant
  (step 2001) its lidar gradients take atol 5e-3 x the largest |grad|
  (measured 2.2e-3);
- params after 5 iterations: at most 0.1% of a tensor's elements differ by
  more than 5e-6 (measured: 1 of 4000, by 1.1e-5), and none by more than
  twice the sum of the 10 learning rates, the most that opposite Adam
  directions can separate them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emernerf_tpu.train.step as jax_step_mod
import emernerf_torch.train.step as step_mod
from emernerf_tpu import config as jax_config
from emernerf_tpu import flagship as jax_flagship
from emernerf_tpu.data.scene import sample_lidar_batch as jax_sample_lidar
from emernerf_tpu.data.scene import sample_pixel_batch as jax_sample_pixel
from emernerf_tpu.flagship import build_flagship as jax_build_flagship
from emernerf_tpu.train.step import build_train_step as jax_build_train_step
from emernerf_tpu.train.step import init_train_state as jax_init_train_state
from emernerf_torch.convert import load_jax_params, state_dict_from_jax
from emernerf_torch.flagship import (
    DEFAULT_PROFILE,
    DYNAMIC,
    REFERENCE_BRICK,
    REFERENCE_HASH,
    build_flagship,
)
from emernerf_torch.train.state import init_train_state
from emernerf_torch.train.step import StepDraws, build_train_step

FP32 = ["nerf.model.table_dtype=float32", "nerf.model.mlp_dtype=float32"]
WIDE = ["nerf.propnet.num_samples_per_prop=[32,16]",
        "nerf.sampling.num_samples=8", "nerf.sampling.sample_topk=6",
        "nerf.sampling.lidar_sample_topk=4"]
# the reference-hash profile shades every sample: no top-K
HASH_WIDE = ["nerf.propnet.num_samples_per_prop=[32,16]", "nerf.sampling.num_samples=8"]
TABLE_SCALE = 2000.0
LOSS_RTOL = {"sky_loss": 1e-3}
GRAD_ATOL, GRAD_RTOL = 2e-3, 1e-3
LIDAR_GRAD_ATOL_AFTER_LR_1E2 = 5e-3
PARAM_ATOL, PARAM_OUTLIERS = 5e-6, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tiny tensors gain little from more, and the
    suite's parallel workers would oversubscribe the cores with spinning
    OpenMP threads (a 5 s test took minutes beside busy workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scale_tables(tree):
    return {k: (_scale_tables(v) if isinstance(v, dict)
                else np.asarray(v) * TABLE_SCALE if k.endswith("table") else np.asarray(v))
            for k, v in tree.items()}


class _Tap:
    """Collects values from inside the jitted JAX step through debug
    callbacks; ``take`` returns those of the last call in program order."""

    def __init__(self):
        self.slots = []

    def __call__(self, value):  # at trace time
        i = len(self.slots)
        self.slots.append(None)
        jax.debug.callback(functools.partial(self._put, i), value)

    def _put(self, i, value):
        self.slots[i] = jax.tree.map(np.asarray, value)

    def take(self):
        out = [v for v in self.slots if v is not None]
        self.slots = [None] * len(self.slots)
        return out


def _draws(recorded, lidar: bool, step_cfg):
    """Split one branch's recorded uniforms into StepDraws."""
    t = [torch.from_numpy(np.array(v)) for v in recorded]
    topk = step_cfg.lidar_sample_topk if lidar else step_cfg.sample_topk
    prune = 0 < topk < step_cfg.num_samples
    n_jit = len(step_cfg.prop_samples) + 1
    jit, rest = t[:n_jit], t[n_jit:]
    topk_u = rest.pop(0) if prune and step_cfg.sample_topk_temp > 0 else None
    agg = rest.pop(0) if step_cfg.has_flow else None  # drawn by the aggregation
    assert not rest
    return StepDraws(tuple(jit), topk_u, agg)


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _named(tree, prop: bool):
    """A JAX gradient tree under the port's parameter names."""
    if not prop:
        return state_dict_from_jax(tree)
    return {f"{i}.{k}": v for i, t in enumerate(tree) for k, v in state_dict_from_jax(t).items()}


def jax_build_profile(profile, overrides):
    """The JAX tiny flagship of a profile: the JAX package's flagship
    dotlist merged over the defaults and the profile's config file."""
    if profile.config_file is None:
        return jax_build_flagship(tiny=True, overrides=list(profile.overrides) + overrides)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_flagship, "load_config",
                  lambda path: jax_config.load_config(path, profile.config_file))
        return jax_build_flagship(tiny=True, overrides=list(profile.overrides) + overrides)


@pytest.fixture(scope="module")
def taps():
    """Taps on every ``jax.random.uniform`` draw and on the gradients the
    JAX step hands to apply_update, for as long as the module runs (one
    step runs between two ``take`` calls, so the profiles can share them)."""
    draws, grads = _Tap(), _Tap()
    uniform, apply_update = jax.random.uniform, jax_step_mod.apply_update

    def tapped_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        v = uniform(key, shape, dtype, minval, maxval)
        draws(v)
        return v

    def tapped_apply_update(tx, g, opt_state, params, lr):
        grads(g)
        return apply_update(tx, g, opt_state, params, lr)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.random, "uniform", tapped_uniform)
        m.setattr(jax_step_mod, "apply_update", tapped_apply_update)
        yield draws, grads


def _jax_side(taps, profile, overrides):
    """The jitted JAX step of a profile, the scaled initial params and the
    taps."""
    draws, grads = taps
    cfg, dataset, jmodel, jprops, step_cfg = jax_build_profile(profile, overrides)
    scene = dataset.scene_tensors()
    r = cfg.data.ray_batch_size
    pb = jax_sample_pixel(scene, jax.random.PRNGKey(3), r, use_timestamps=True)
    state = jax.jit(lambda k: jax_init_train_state(jmodel, jprops, step_cfg, k, pb))(
        jax.random.PRNGKey(1))
    params = _scale_tables(jax.tree.map(np.asarray, state.params))
    prop_params = tuple(_scale_tables(jax.tree.map(np.asarray, p))
                        for p in state.prop_params)
    state = jax.tree.map(np.asarray, state)
    draws.take()  # the initializers' draws
    return dict(step=jax_build_train_step(jmodel, jprops, step_cfg), state=state,
                params=params, prop_params=prop_params, scene=scene, r=r,
                step_cfg=step_cfg, draws=draws, grads=grads, profile=profile,
                overrides=overrides)


@pytest.fixture(scope="module")
def jax_side(taps):
    return _jax_side(taps, DEFAULT_PROFILE, FP32 + WIDE)


@pytest.fixture(scope="module")
def hash_jax_side(taps):
    return _jax_side(taps, REFERENCE_HASH, FP32 + HASH_WIDE)


@pytest.fixture(scope="module")
def dynamic_jax_side(taps):
    return _jax_side(taps, DYNAMIC, FP32 + WIDE)


@pytest.fixture(scope="module")
def reference_brick_jax_side(taps):
    return _jax_side(taps, REFERENCE_BRICK, FP32 + HASH_WIDE)


class Pair:
    """Both packages' states and steps from the same params."""

    def __init__(self, js, step: int = 0):
        self.js = js
        # fresh buffers: the jitted step donates its state
        self.jstate = jax.tree.map(jnp.array, js["state"]).replace(
            params=jax.tree.map(jnp.asarray, js["params"]),
            prop_params=jax.tree.map(jnp.asarray, js["prop_params"]),
            step=jnp.asarray(step, jnp.int32))
        _, _, tmodel, tprops, tcfg = build_flagship(tiny=True, overrides=js["overrides"],
                                                    profile=js["profile"], device="cpu")
        load_jax_params(tmodel, tprops, js["params"], js["prop_params"])
        self.tstate = init_train_state(tmodel, tprops)
        self.tstate.step = step
        self.tstep = build_train_step(tmodel, tprops, tcfg)
        self.names = [n for n, _ in tmodel.named_parameters()]
        self.prop_names = [f"{i}.{n}" for i, pm in enumerate(tprops)
                           for n, _ in pm.named_parameters()]

    def batches(self, seed):
        kp, kl = jax.random.split(jax.random.PRNGKey(100 + seed))
        js = self.js
        pb = jax.tree.map(np.asarray, jax_sample_pixel(js["scene"], kp, js["r"],
                                                       use_timestamps=True))
        lb = jax.tree.map(np.asarray, jax_sample_lidar(js["scene"], kl, js["r"]))
        return pb, lb

    def run(self, pb, lb, pixel_rg, lidar_rg, seed, monkeypatch):
        """One iteration of both; returns (jax metrics, port metrics, jax
        grads, port grads), grads in update order."""
        js = self.js
        self.jstate, jm = js["step"](self.jstate, pb, lb, jax.random.PRNGKey(seed),
                                     pixel_rg=pixel_rg, lidar_rg=lidar_rg)
        jm = {k: float(v) for k, v in jm.items()}
        draws, jgrads = js["draws"].take(), js["grads"].take()
        n_pix = len(draws) // 2
        pd = _draws(draws[:n_pix], False, js["step_cfg"])
        ld = _draws(draws[n_pix:], True, js["step_cfg"])
        tgrads = []
        orig = step_mod.apply_update

        def record(tx, g, opt_state, params, lr):
            tgrads.append([None if x is None else x.detach().clone() for x in g])
            return orig(tx, g, opt_state, params, lr)

        with monkeypatch.context() as m:
            m.setattr(step_mod, "apply_update", record)
            tm = self.tstep(self.tstate, _to_torch(pb), _to_torch(lb), pd, ld,
                            pixel_rg, lidar_rg)
        return jm, {k: float(v) for k, v in tm.items()}, jgrads, tgrads


def _assert_grads_close(jg, tg, names, atol=GRAD_ATOL):
    for name, t in zip(names, tg):
        ref = jg[name].numpy()
        ours = np.zeros_like(ref) if t is None else t.numpy()
        np.testing.assert_allclose(ours, ref, rtol=GRAD_RTOL,
                                   atol=atol * float(np.abs(ref).max()), err_msg=name)


def _assert_params_close(ours, ref, lr_sum, name):
    d = np.abs(ours - ref)
    assert (d > PARAM_ATOL).mean() <= PARAM_OUTLIERS, (name, (d > PARAM_ATOL).sum())
    assert d.max() <= 2 * lr_sum, (name, d.max())


def _assert_losses_close(tm, jm):
    assert set(tm) == set(jm)
    for k, v in jm.items():
        assert np.isclose(tm[k], v, rtol=LOSS_RTOL.get(k, 1e-4), atol=1e-7), (k, tm[k], v)


@pytest.mark.parametrize("variant", ["rg", "pixel_no_rg", "los"])
def test_one_iteration_matches_jax(jax_side, variant, monkeypatch):
    pair = Pair(jax_side, step=2001 if variant == "los" else 0)
    pixel_rg = variant != "pixel_no_rg"
    pb, lb = pair.batches(0)
    jm, tm, jgrads, tgrads = pair.run(pb, lb, pixel_rg, True, seed=7, monkeypatch=monkeypatch)
    _assert_losses_close(tm, jm)
    assert (jm["prop_loss"] > 0) == pixel_rg
    assert (jm["lidar_line_of_sight"] > 0) == (variant == "los")
    pixel = ["prop", "model"] if pixel_rg else ["model"]
    order = pixel + ["prop", "model"]
    assert len(jgrads) == len(tgrads) == len(order)
    lidar_atol = LIDAR_GRAD_ATOL_AFTER_LR_1E2 if variant == "los" else GRAD_ATOL
    for i, (kind, jg, tg) in enumerate(zip(order, jgrads, tgrads)):
        _assert_grads_close(_named(jg, kind == "prop"), tg,
                            pair.prop_names if kind == "prop" else pair.names,
                            atol=GRAD_ATOL if i < len(pixel) else lidar_atol)


def test_reference_hash_iteration_matches_jax(hash_jax_side, monkeypatch):
    """One iteration of the reference-hash profile, both branches with
    proposal gradients: every loss and every gradient handed to Adam."""
    pair = Pair(hash_jax_side)
    assert not pair.tstate.model.fused and pair.tstep.cfg.sample_topk == 0
    pb, lb = pair.batches(0)
    jm, tm, jgrads, tgrads = pair.run(pb, lb, True, True, seed=7, monkeypatch=monkeypatch)
    _assert_losses_close(tm, jm)
    assert jm["prop_loss"] > 0 and jm["cycle_loss"] > 0
    order = ["prop", "model", "prop", "model"]
    assert len(jgrads) == len(tgrads) == len(order)
    for kind, jg, tg in zip(order, jgrads, tgrads):
        _assert_grads_close(_named(jg, kind == "prop"), tg,
                            pair.prop_names if kind == "prop" else pair.names)


@pytest.mark.parametrize("side", ["dynamic_jax_side", "reference_brick_jax_side"],
                         ids=["dynamic", "reference_brick"])
def test_profile_iteration_matches_jax(side, request, monkeypatch):
    """One iteration of the dynamic-only profile (top-K pruning, no flow:
    no cycle loss) and of the reference-brick profile (separate dynamic
    and flow brick grids of unpaired 4D rows, every sample shaded and
    flow-warped), both branches with proposal gradients: every loss and
    every gradient handed to Adam."""
    pair = Pair(request.getfixturevalue(side))
    model, cfg = pair.tstate.model, pair.tstep.cfg
    if side == "dynamic_jax_side":
        assert not model.has_flow and not cfg.has_flow and cfg.sample_topk == 6
    else:
        assert model.has_flow and not model.fused and cfg.sample_topk == 0
        assert not model.dynamic_spec.uses_time_pair and not model.flow_spec.uses_time_pair
    pb, lb = pair.batches(0)
    jm, tm, jgrads, tgrads = pair.run(pb, lb, True, True, seed=7, monkeypatch=monkeypatch)
    _assert_losses_close(tm, jm)
    assert jm["prop_loss"] > 0 and jm["dynamic_reg_loss"] > 0
    assert ("cycle_loss" in jm) == cfg.has_flow
    order = ["prop", "model", "prop", "model"]
    assert len(jgrads) == len(tgrads) == len(order)
    for kind, jg, tg in zip(order, jgrads, tgrads):
        _assert_grads_close(_named(jg, kind == "prop"), tg,
                            pair.prop_names if kind == "prop" else pair.names)


def test_loss_trajectory_matches_jax(jax_side, monkeypatch):
    """Five iterations (steps 1-5, every render with proposal gradients):
    every loss of every iteration, then every parameter."""
    pair = Pair(jax_side, step=1)
    first = {n: p.detach().clone() for n, p in pair.tstate.model.named_parameters()}
    lr_sum = sum(pair.tstep.lr_fn(c) for c in range(2, 12))
    for it in range(1, 6):
        pb, lb = pair.batches(it)
        jm, tm, _, _ = pair.run(pb, lb, True, True, seed=10 + it, monkeypatch=monkeypatch)
        _assert_losses_close(tm, jm)
    assert pair.tstate.step == int(pair.jstate.step) == 6
    jp = _named(jax.tree.map(np.asarray, pair.jstate.params), False)
    for name, p in pair.tstate.model.named_parameters():
        _assert_params_close(p.detach().numpy(), jp[name].numpy(), lr_sum, name)
        assert not torch.equal(p, first[name]), name
    jpp = _named(jax.tree.map(np.asarray, pair.jstate.prop_params), True)
    for name, p in zip(pair.prop_names, pair.tstate.prop_params):
        _assert_params_close(p.detach().numpy(), jpp[name].numpy(), lr_sum, name)


def test_step_config_matches_jax():
    *_, jcfg = jax_build_flagship(tiny=False)
    *_, tcfg = build_flagship(tiny=True, device="cpu")
    *_, tcfg_full = jax_build_flagship(tiny=True)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(tcfg_full)
    assert set(dataclasses.asdict(tcfg)) == set(dataclasses.asdict(jcfg))
