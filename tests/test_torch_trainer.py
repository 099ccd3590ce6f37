"""The port's data path and trainer on the CPU.

``sample_pixel_batch`` (uniform and error-buffer rays), ``sample_lidar_batch``
and ``update_pixel_error_map`` against ``emernerf_tpu.data.scene`` with the
draws JAX makes from its key (derived here exactly as the JAX sampler
derives them); then the tiny flagship trained for a few iterations by
``Trainer``: the requires-grad schedule, an error-map refresh, buffered
sampling and a step with the line-of-sight loss live.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emernerf_tpu.data import scene as jscene
from emernerf_tpu.flagship import build_flagship as jax_build_flagship
from emernerf_torch.builders import build_dataset_from_cfg
from emernerf_torch.data import scene as tscene
from emernerf_torch.eval.points import PointQueryEngine
from emernerf_torch.eval.renderer import ImageRenderer
from emernerf_torch.flagship import (
    DYNAMIC,
    REFERENCE_BRICK,
    REFERENCE_HASH,
    build_flagship,
    flagship_config,
    flagship_flow_spec,
)
from emernerf_torch.train.trainer import Trainer, raise_on_nonfinite


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tiny tensors gain little from more, and the
    suite's parallel workers would oversubscribe the cores with spinning
    OpenMP threads (a 5 s test took minutes beside busy workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    _, dataset, *_ = jax_build_flagship(tiny=True)
    jsc = dataset.scene_tensors()
    tsc = build_dataset_from_cfg(flagship_config(tiny=True)).scene_tensors()
    return jsc, tsc


def test_scene_tensors_match_jax(scenes):
    jsc, tsc = scenes
    for k in ("images", "c2w", "intrinsics", "normed_timestamps", "cam_ids", "train_indices",
              "sky_masks", "lidar_origins", "lidar_viewdirs", "lidar_ranges",
              "lidar_normed_timestamps"):
        np.testing.assert_array_equal(getattr(tsc, k).numpy(), np.asarray(getattr(jsc, k)), k)


@pytest.mark.parametrize("buffered", [False, True], ids=["uniform", "error_buffer"])
def test_pixel_batch_matches_jax(scenes, buffered):
    # an error buffer of 4x6 entries per image, refreshed from "renders"
    rng = np.random.default_rng(0)
    pred, gt, dyn = (rng.uniform(0, 1, (3, 4, 6, 3)).astype(np.float32) for _ in range(3))
    dyn = dyn[..., 0]
    jsc = jscene.update_pixel_error_map(scenes[0], *(jnp.asarray(a) for a in (pred, gt, dyn)))
    tsc = tscene.update_pixel_error_map(scenes[1], *(torch.from_numpy(a) for a in (pred, gt, dyn)))
    np.testing.assert_allclose(tsc.pixel_error_map.numpy(), np.asarray(jsc.pixel_error_map),
                               rtol=1e-6, atol=1e-7)
    n, ratio, bd = 64, 0.25 if buffered else 0.0, 4
    key = jax.random.PRNGKey(11)
    ref = jscene.sample_pixel_batch(jsc, key, n, buffer_ratio=ratio, buffer_downscale=bd)
    # the sampler's own draws, from its own key splits
    k_img, k_x, k_y, k_imp, k_off = jax.random.split(key, 5)
    n_roi = tscene.num_roi(tsc, n, ratio)
    n_uni = n - n_roi
    h, w = tsc.image_hw

    def t(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64))

    draws = tscene.PixelDraws(t(jax.random.randint(k_img, (n_uni,), 0, 3)),
                              t(jax.random.randint(k_x, (n_uni,), 0, w)),
                              t(jax.random.randint(k_y, (n_uni,), 0, h)))
    if n_roi:
        assert n_roi == 16
        u = jax.random.uniform(k_imp, (72,), minval=1e-12)
        draws = draws._replace(gumbel_u=torch.from_numpy(np.asarray(u)),
                               offsets=t(jax.random.randint(k_off, (2, n_roi), 0, bd)))
    ours = tscene.sample_pixel_batch(tsc, draws, bd)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_lidar_batch_matches_jax(scenes):
    jsc, tsc = scenes
    key = jax.random.PRNGKey(5)
    ref = jscene.sample_lidar_batch(jsc, key, 32)
    idx = jax.random.randint(key, (32,), 0, jsc.lidar_origins.shape[0])
    ours = tscene.sample_lidar_batch(tsc, torch.from_numpy(np.asarray(idx).astype(np.int64)))
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), k)


def test_trainer_runs_the_tiny_flagship():
    cfg = flagship_config(tiny=True, overrides=["optim.cache_rgb_freq=2",
                                                "optim.check_nan=true", "logging.print_freq=1"])
    trainer = Trainer(cfg, device="cpu", flow=flagship_flow_spec(cfg, tiny=True))
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    metrics = [trainer.train_iteration(step) for step in range(4)]
    assert trainer.error_map_buffered  # refreshed at step 2; step 3 sampled from it
    assert [m["pixel_rg"] for m in metrics] == [False, True, True, True]
    assert all(m["lidar_rg"] for m in metrics)
    assert trainer.state.step == 4
    trainer.state.step = 2001  # past supervision.depth.line_of_sight.start_iter
    metrics.append(trainer.train_iteration(2001))
    assert metrics[-1]["lidar_line_of_sight"] > 0 and metrics[0]["lidar_line_of_sight"] == 0
    assert trainer.train(2002).step == 2003
    for m in metrics:
        assert all(np.isfinite(float(v)) for v in m.values())
    for name, p in trainer.model.named_parameters():
        assert not torch.equal(p, before[name]), name
    with pytest.raises(RuntimeError, match="Non-finite"):
        raise_on_nonfinite({"rgb_loss": float("nan"), "lr": 1.0}, 7)


def test_trainer_runs_the_tiny_reference_hash_flagship():
    """The reference-hash profile through Trainer: hash grids, separate
    dynamic and flow grids, an error-map refresh through the eval render."""
    cfg = flagship_config(tiny=True, overrides=["optim.cache_rgb_freq=2"], profile=REFERENCE_HASH)
    trainer = Trainer(cfg, device="cpu", flow=flagship_flow_spec(cfg, tiny=True))
    assert not trainer.model.fused and trainer.step_cfg.sample_topk == 0
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    metrics = [trainer.train_iteration(step) for step in range(3)]
    assert trainer.error_map_buffered
    for m in metrics:
        assert all(np.isfinite(float(v)) for v in m.values())
    for name, p in trainer.model.named_parameters():
        assert not torch.equal(p, before[name]), name


@pytest.mark.parametrize("profile", [DYNAMIC, REFERENCE_BRICK],
                         ids=["dynamic", "reference_brick"])
def test_trainer_runs_the_tiny_profile(profile):
    """The dynamic-only profile (no flow grid, MLP or cycle loss) and the
    reference-brick profile (separate dynamic and flow brick grids of
    unpaired 4D rows) through build_flagship, Trainer and ImageRenderer."""
    _, _, model, props, step_cfg = build_flagship(tiny=True, profile=profile, device="cpu")
    assert model.has_dynamic and not model.fused and step_cfg.has_flow == model.has_flow
    assert model.has_flow == (profile is REFERENCE_BRICK)
    cfg = flagship_config(tiny=True, overrides=["optim.cache_rgb_freq=2"], profile=profile)
    trainer = Trainer(cfg, device="cpu", flow=flagship_flow_spec(cfg, tiny=True))
    assert trainer.model.has_flow == model.has_flow
    if model.has_flow:
        assert not trainer.model.flow_spec.uses_time_pair
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    metrics = [trainer.train_iteration(step) for step in range(3)]
    assert trainer.error_map_buffered
    for m in metrics:
        assert all(np.isfinite(float(v)) for v in m.values())
        assert ("cycle_loss" in m) == model.has_flow and "dynamic_reg_loss" in m
    for name, p in trainer.model.named_parameters():
        assert not torch.equal(p, before[name]), name
    frames, _ = trainer.renderer.render_split(trainer.dataset, [0])
    assert ("forward_flow" in frames[0]) == model.has_flow and "shadow_ratio" in frames[0]
    assert all(np.isfinite(v).all() for v in frames[0].values())


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device given the entry points run on the card, and on a host
    without one they raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = flagship_config(tiny=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_flagship(tiny=True)
    _, _, model, props, _ = build_flagship(tiny=True, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImageRenderer(model, props)
    assert ImageRenderer(model, props, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PointQueryEngine(model)
    assert PointQueryEngine(model, device="cpu").device.type == "cpu"
