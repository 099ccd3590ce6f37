"""Port parity: ``optim.fused_lidar_branch`` (one render of the pixel and
lidar rays together, one backward, one Adam update per iteration) against
the JAX package's fused step on the tiny flagship, on the CPU in fp32; its
two conflicts with per-branch lidar settings; the trainer's draws for it.

The JAX step's draws (one render: three stratified jitters, the top-K
Gumbel uniforms and the aggregation noise, each for the 2R combined rays)
and the gradients it hands to ``apply_update`` are tapped as in
``test_torch_train_step``; tolerances are that file's: losses rtol 1e-4
(the sky loss 1e-3), gradients per tensor rtol 1e-3 and atol 2e-3 x the
largest |grad|, params after the update as its trajectory test.
"""

import jax
import numpy as np
import pytest
import torch

from emernerf_torch.builders import build_train_step_config
from emernerf_torch.flagship import DEFAULT_PROFILE, build_flagship, flagship_config
from emernerf_torch.train import step as step_mod
from emernerf_torch.train.step import build_train_step, combined_batch
from test_torch_train_step import (  # noqa: F401  (taps: a fixture)
    FP32,
    WIDE,
    Pair,
    _assert_grads_close,
    _assert_losses_close,
    _assert_params_close,
    _draws,
    _jax_side,
    _named,
    _to_torch,
    taps,
)

FUSED = ["optim.fused_lidar_branch=true"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fused_jax_side(taps):
    return _jax_side(taps, DEFAULT_PROFILE, FP32 + WIDE + FUSED)


def _run_fused(pair, pb, lb, pixel_rg, lidar_rg, seed, monkeypatch):
    """One fused iteration of both packages: (jax metrics, port metrics,
    jax grads, port grads)."""
    js = pair.js
    pair.jstate, jm = js["step"](pair.jstate, pb, lb, jax.random.PRNGKey(seed),
                                 pixel_rg=pixel_rg, lidar_rg=lidar_rg)
    jm = {k: float(v) for k, v in jm.items()}
    draws = _draws(js["draws"].take(), False, js["step_cfg"])
    assert draws.jitters[0].shape[0] == 2 * js["r"]  # one render of both batches
    jgrads, tgrads = js["grads"].take(), []
    orig = step_mod.apply_update

    def record(tx, g, opt_state, params, lr):
        tgrads.append([None if x is None else x.detach().clone() for x in g])
        return orig(tx, g, opt_state, params, lr)

    with monkeypatch.context() as m:
        m.setattr(step_mod, "apply_update", record)
        tm = pair.tstep(pair.tstate, _to_torch(pb), _to_torch(lb), draws, None,
                        pixel_rg, lidar_rg)
    return jm, {k: float(v) for k, v in tm.items()}, jgrads, tgrads


@pytest.mark.parametrize("rg", [(True, True), (False, True)], ids=["both_rg", "lidar_rg"])
def test_fused_iteration_matches_jax(fused_jax_side, rg, monkeypatch):
    """Every loss and metric, every gradient handed to Adam (the proposal
    nets' too when either branch asks for proposal gradients: the lidar
    branch alone is enough) and the updated params; the lr at scheduler
    count 2 * step, as JAX counts."""
    pair = Pair(fused_jax_side, step=3)
    assert pair.tstep.cfg.fused_branches and pair.tstep.steps_per_iter == 2
    pb, lb = pair.batches(0)
    jm, tm, jgrads, tgrads = _run_fused(pair, pb, lb, *rg, seed=7, monkeypatch=monkeypatch)
    _assert_losses_close(tm, jm)
    assert tm["lr"] == pytest.approx(pair.tstep.lr_fn(6), rel=1e-6)
    assert jm["prop_loss"] > 0 and jm["lidar_range_loss"] > 0
    order = ["prop", "model"]
    assert len(jgrads) == len(tgrads) == len(order)
    for kind, jg, tg in zip(order, jgrads, tgrads):
        _assert_grads_close(_named(jg, kind == "prop"), tg,
                            pair.prop_names if kind == "prop" else pair.names)
    assert pair.tstate.step == int(pair.jstate.step) == 4
    lr = pair.tstep.lr_fn(6)
    jp = _named(jax.tree.map(np.asarray, pair.jstate.params), False)
    for name, p in pair.tstate.model.named_parameters():
        _assert_params_close(p.detach().numpy(), jp[name].numpy(), lr, name)


def test_combined_batch_takes_the_union_of_keys():
    """Pixel rays, then lidar rays; a key only one side has takes zeros on
    the other."""
    pixel = {"origins": torch.ones(3, 3), "viewdirs": torch.ones(3, 3),
             "img_idx": torch.tensor([1, 2, 3]), "pixels": torch.ones(3, 3)}
    lidar = {"origins": torch.zeros(2, 3), "viewdirs": torch.zeros(2, 3),
             "normed_timestamps": torch.tensor([0.5, 0.25]), "ranges": torch.ones(2)}
    comb, rp = combined_batch(pixel, lidar)
    assert rp == 3 and set(comb) == {"origins", "viewdirs", "img_idx", "normed_timestamps"}
    assert comb["img_idx"].tolist() == [1, 2, 3, 0, 0]
    assert comb["normed_timestamps"].tolist() == [0.0, 0.0, 0.0, 0.5, 0.25]


def test_fused_branch_conflicts_raise():
    """Per-branch lidar settings that one combined render cannot honour
    raise the JAX package's ValueErrors: proposal sample counts for the
    lidar branch, and an explicit staged lidar-K."""
    cfg, dataset, model, props, _ = build_flagship(tiny=True, overrides=FUSED, device="cpu")
    prop = flagship_config(tiny=True, overrides=FUSED + [
        "nerf.propnet.lidar_num_samples_per_prop=[4,2]"])
    with pytest.raises(ValueError, match="no effect with optim.fused_lidar_branch"):
        build_train_step_config(prop, dataset)
    staged = flagship_config(tiny=True, overrides=FUSED + ["nerf.sampling.lidar_topk_until=0.5"])
    assert staged.nerf.sampling.lidar_topk_until == 0.5  # an explicit setting stays
    with pytest.raises(ValueError, match="lidar_topk_until"):
        build_train_step(model, props, build_train_step_config(staged, dataset))


def test_trainer_draws_one_render_of_both_batches():
    """The fused trainer draws once per iteration, for both batches (and
    no lidar draws), and every loss of a few iterations is finite."""
    from emernerf_torch.flagship import flagship_flow_spec
    from emernerf_torch.train.trainer import Trainer

    cfg = flagship_config(tiny=True, overrides=FUSED)
    trainer = Trainer(cfg, device="cpu", flow=flagship_flow_spec(cfg, tiny=True))
    seen, step = [], trainer.train_step

    class Spy:
        def __getattr__(self, name):
            return getattr(step, name)

        def __call__(self, state, pb, lb, pd, ld, *args):
            seen.append((pd.jitters[0].shape[0], ld))
            return step(state, pb, lb, pd, ld, *args)

    trainer.train_step = Spy()
    for i in range(2):
        m = trainer.train_iteration(i)
        assert all(np.isfinite(float(v)) for v in m.values()), m
    assert seen == [(2 * cfg.data.ray_batch_size, None)] * 2
