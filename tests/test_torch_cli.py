"""The port's training CLI and trainer plumbing on the CPU: the
counterparts of ``tests/test_cli.py`` (dotlist and ``setup``, a
train-and-eval run, ``--auto_resume``), the stock flow config's scene-flow
evaluation and videos, ``--visualize_voxel``, the data videos, and
``tests/test_train.py`` (SIGTERM preemption, the NaN tripwire restoring
the signal handlers, the wall-clock ``log_every``, wandb's retries), run
through
``emernerf_torch.train_emernerf.main(["--device", "cpu", ...])`` on the
tiny synthetic config of ``tests/test_cli.py``.  ``utils/logging.py`` is
held to the JAX package's original, less its ``data_time`` (the time of
``next()`` on the step range: the port samples inside the iteration).
"""

import inspect
import json
import logging
import os
import signal
import sys
import time
import types

import numpy as np
import pytest
import torch
from test_cli import TINY_OVERRIDES

from emernerf_torch import flagship as flagship_mod
from emernerf_torch.config import from_dotlist
from emernerf_torch.flagship import flagship_config, flagship_flow_spec
from emernerf_torch.train import trainer as trainer_mod
from emernerf_torch.train.trainer import Trainer
from emernerf_torch.train_emernerf import get_args_parser, main, setup
from emernerf_torch.utils import logging as port_logging
from emernerf_tpu.utils import logging as jax_logging

# a few iterations: the CPU runs the kernels' plain versions
SHORT = ["optim.num_iters=4", "logging.print_freq=2"]
NO_EVAL = ["render.render_low_res=false"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _signal_handlers():
    """Every test leaves the process's handlers as it found them."""
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield before
    for s, h in before.items():
        assert signal.getsignal(s) is h, s
        signal.signal(s, h)


def _argv(tmp_path, run, *flags):
    return ["--device", "cpu", "--output_root", str(tmp_path), "--project", "p",
            "--run_name", run, *flags]


def _ckpts(run_dir):
    return sorted(p.name for p in run_dir.glob("checkpoint_*"))


def test_cli_dotlist_overrides(tmp_path):
    args = get_args_parser().parse_args(
        _argv(tmp_path, "r2") + ["optim.lr=0.123", "data.scene_idx=42"])
    cfg = setup(args)
    assert cfg.optim.lr == 0.123 and cfg.data.scene_idx == 42
    run_dir = tmp_path / "p" / "r2"
    assert (run_dir / "config.yaml").exists()
    assert len(list((run_dir / "configs_bk").glob("config_*.yaml"))) == 1
    assert cfg.log_dir == str(run_dir) and cfg.project == "p" and cfg.run_name == "r2"
    assert args.device == "cpu" and get_args_parser().parse_args([]).device == "cuda"


def test_cli_train_eval_and_eval_only(tmp_path):
    """Train with the profiler window and an error-map refresh, evaluate at
    the end, then --eval_only from the newest checkpoint."""
    extra = SHORT + ["optim.cache_rgb_freq=2", "logging.profiling_start_iter=1",
                     "logging.profiling_num_iters=1"]
    trainer = main(_argv(tmp_path, "r") + TINY_OVERRIDES + extra)
    run_dir = tmp_path / "p" / "r"
    assert not trainer.preempted and trainer.state.step == 5
    assert (run_dir / "config.yaml").exists()
    records = [json.loads(x) for x in (run_dir / "metrics.json").read_text().splitlines()]
    assert records and all("iter_time" in r for r in records)
    assert "rgb_loss" in records[-1]
    assert _ckpts(run_dir) == ["checkpoint_00005"]  # saveckpt_freq=0: the final one only
    chrome = json.loads((run_dir / "profile" / "trace_00002.json").read_text())
    # the port's spans over the window's kernels, one iteration a step
    names = [e.get("name") for e in chrome["traceEvents"]]
    assert names.count("trainer.iteration") == 2 and "step.backward" in names
    assert sorted(p.name for p in (run_dir / "buffer_maps").glob("*.npy")) == [
        "buffer_00003.npy", "buffer_00005.npy"]
    results = json.loads((run_dir / "metrics_all_5.json").read_text())
    assert np.isfinite(results["lowres/psnr"])
    assert np.isfinite(results["lidar/depth_rmse"])
    assert (run_dir / "metrics_lowres_5.json").exists()

    os.remove(run_dir / "metrics_all_5.json")
    again = main(_argv(tmp_path, "r", "--eval_only") + TINY_OVERRIDES + extra)
    assert again.cfg.resume_from.endswith("checkpoint_00005") and again.state.step == 5
    rerun = json.loads((run_dir / "metrics_all_5.json").read_text())
    assert rerun["lowres/psnr"] == pytest.approx(results["lowres/psnr"], rel=1e-6)


# the dynamic grid at the tiny sizes of the static one
TINY_DYNAMIC = ["nerf.model.dynamic_xyz_encoder.n_levels=4",
                "nerf.model.dynamic_xyz_encoder.log2_hashmap_size=12",
                "nerf.model.dynamic_xyz_encoder.max_resolution=128"]


@pytest.mark.parametrize("config_file,extra", [
    ("configs/default_dynamic.yaml", []),
    # the flow grid's spec is fixed (10 levels, 2^18 cells): unpaired rows
    ("configs/reference_semantics.yaml", ["nerf.model.head.enable_dynamic_branch=true",
                                          "nerf.model.head.enable_flow_branch=true"]),
], ids=["default_dynamic", "reference_semantics"])
def test_cli_trains_and_evaluates_a_stock_config(tmp_path, config_file, extra):
    """``--config_file`` of the stock dynamic-only config and of the
    reference-semantics profile on brick grids: 2 iterations and the
    evaluation; the dynamic-only model has no flow."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trainer = main(_argv(tmp_path, "cfg", "--config_file", os.path.join(repo, config_file))
                   + TINY_OVERRIDES + TINY_DYNAMIC + NO_EVAL + extra
                   + ["optim.num_iters=1", "logging.print_freq=1"])
    model = trainer.model
    assert trainer.state.step == 2 and model.has_dynamic and not model.fused
    assert model.has_flow == ("reference" in config_file)
    if model.has_flow:
        assert not model.dynamic_spec.uses_time_pair and not model.flow_spec.uses_time_pair
    records = [json.loads(x) for x in (tmp_path / "p" / "cfg" / "metrics.json")
               .read_text().splitlines()]
    assert records and np.isfinite(records[-1]["dynamic_reg_loss"])
    assert ("cycle_loss" in records[-1]) == model.has_flow
    rays, _ = trainer.dataset.get_image_rays(0, downscale=4)
    out = trainer.renderer.render_rays_chunked(rays)
    assert ("forward_flow" in out) == model.has_flow and "dynamic_rgb" in out
    assert all(np.isfinite(v).all() for v in out.values())


def test_cli_eval_only_needs_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="needs a checkpoint"):
        main(_argv(tmp_path, "none", "--eval_only") + TINY_OVERRIDES)


def test_cli_auto_resume_continues_and_keeps_checkpointing(tmp_path):
    """--auto_resume resumes from the newest checkpoint and keeps periodic
    saves on; a hand-set resume_from never saves a periodic one (the
    reference's quirk), only the final checkpoint."""
    base = TINY_OVERRIDES + NO_EVAL + ["logging.print_freq=2"]
    main(_argv(tmp_path, "ar") + base + ["optim.num_iters=2"])
    run_dir = tmp_path / "p" / "ar"
    assert _ckpts(run_dir) == ["checkpoint_00003"]
    more = ["optim.num_iters=5", "logging.saveckpt_freq=4"]
    t = main(_argv(tmp_path, "ar", "--auto_resume") + base + more)
    assert t.start_step == 3 and t.state.step == 6
    assert _ckpts(run_dir) == ["checkpoint_00003", "checkpoint_00005", "checkpoint_00006"]
    # --auto_resume with an empty run directory starts from scratch
    fresh = main(_argv(tmp_path, "new", "--auto_resume") + base + ["optim.num_iters=0"])
    assert fresh.start_step == 0 and _ckpts(tmp_path / "p" / "new") == ["checkpoint_00001"]

    hand = f"resume_from={run_dir / 'checkpoint_00003'}"
    t = main(_argv(tmp_path, "hand") + base + more + [hand])
    assert t.start_step == 3
    assert _ckpts(tmp_path / "p" / "hand") == ["checkpoint_00006"]


def _tiny_trainer(tmp_path, *overrides):
    cfg = flagship_config(tiny=True, overrides=["optim.num_iters=50", "logging.print_freq=10",
                                                "logging.saveckpt_freq=0", *overrides])
    return Trainer(cfg, str(tmp_path), device="cpu", flow=flagship_flow_spec(cfg, tiny=True))


def test_preemption_saves_checkpoint_and_exits_cleanly(tmp_path, monkeypatch, _signal_handlers):
    """The first SIGTERM lets the in-flight iteration finish, saves
    checkpoint_{step}, restores the previous handlers and returns."""
    trainer = _tiny_trainer(tmp_path)
    real = trainer.train_iteration
    seen = {}

    def signaling_iteration(step):
        out = real(step)
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
            # restored on first receipt: a second signal acts the old way
            seen["handler"] = signal.getsignal(signal.SIGTERM)
        return out

    monkeypatch.setattr(trainer, "train_iteration", signaling_iteration)
    state = trainer.train()
    assert trainer.preempted and state.step == 4
    assert _ckpts(tmp_path) == ["checkpoint_00004"]
    assert seen["handler"] is _signal_handlers[signal.SIGTERM]


def test_nan_tripwire_halts_training_and_restores_handlers(tmp_path, monkeypatch,
                                                           _signal_handlers):
    trainer = _tiny_trainer(tmp_path, "optim.check_nan=true", "logging.print_freq=1")
    real = trainer.train_step

    class PoisonedStep:
        render_kw = real.render_kw

        def __call__(self, *args):
            metrics = real(*args)
            metrics["rgb_loss"] = torch.tensor(float("nan"))
            return metrics

    monkeypatch.setattr(trainer, "train_step", PoisonedStep())
    with pytest.raises(RuntimeError, match="Non-finite loss"):
        trainer.train()
    for s, h in _signal_handlers.items():
        assert signal.getsignal(s) is h
    assert not _ckpts(tmp_path)


FLOW_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs", "default_flow.yaml")
# the stock flow config on the tiny scene (one camera, the dynamic sphere)
TINY_FLOW = (["--config_file", FLOW_CONFIG] + TINY_OVERRIDES + TINY_DYNAMIC
             + ["data.synthetic.dynamic=true", "data.pixel_source.num_cams=1"])


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("imageio", [True, False], ids=["videos", "no_imageio"])
def test_cli_default_flow_writes_flow_metrics_and_videos(tmp_path, monkeypatch, imageio):
    """``configs/default_flow.yaml`` (``eval.eval_lidar_flow``) with the novel
    trajectory: trains, then writes ``metrics_flow_{step}.json`` with the five
    NSFP metrics, the lowres and novel videos, and without ``imageio`` one
    warning, no video and every metric as before."""
    if not imageio:
        monkeypatch.setitem(sys.modules, "imageio", None)
        monkeypatch.setitem(sys.modules, "imageio.v2", None)
    warnings = _Warnings()
    logging.getLogger("emernerf_torch").addHandler(warnings)
    try:
        trainer = main(_argv(tmp_path, "flow") + TINY_FLOW
                       + ["optim.num_iters=1", "render.render_novel_trajectory=true"])
    finally:
        logging.getLogger("emernerf_torch").removeHandler(warnings)
    run_dir = tmp_path / "p" / "flow"
    assert trainer.model.fused and trainer.cfg.eval.eval_lidar_flow
    flow = json.loads((run_dir / "metrics_flow_2.json").read_text())
    assert set(flow) == {"EPE3D", "acc3d_strict", "acc3d_relax", "angle_error", "outlier"}
    assert all(np.isfinite(v) for v in flow.values())
    results = json.loads((run_dir / "metrics_all_2.json").read_text())
    assert results["flow/EPE3D"] == flow["EPE3D"] and np.isfinite(results["lowres/psnr"])
    videos = sorted(p.stem for p in (run_dir / "videos").glob("*"))
    no_video = [m for m in warnings.messages if "no videos" in m]
    if imageio:
        assert videos == ["lowres_2", "novel_2"] and not no_video
    else:
        assert videos == [] and len(no_video) == 1


@pytest.mark.parametrize("flag", ["--visualize_voxel", "--render_data_video",
                                  "--render_data_video_only"])
def test_cli_flag_runs(tmp_path, flag):
    """--render_data_video_only writes the data video and builds no model;
    --render_data_video writes it and trains; --visualize_voxel picks the
    newest checkpoint as --eval_only does, exports the occupied voxels of
    each training timestep (.npz, .html) and the lidar scene flow, then
    evaluates with the top-K pruned render (render.eval_sample_topk)."""
    run_dir = tmp_path / "p" / "x"
    argv = _argv(tmp_path, "x", flag) + TINY_FLOW + NO_EVAL + ["optim.num_iters=1"]
    if flag == "--visualize_voxel":
        main(_argv(tmp_path, "x") + TINY_FLOW + NO_EVAL + ["optim.num_iters=1"])
        trainer = main(argv + ["render.vis_voxel_size=4.0", "render.eval_sample_topk=3"])
        assert trainer.cfg.resume_from.endswith("checkpoint_00002")
        assert trainer.renderer.kw["sample_topk"] == 3
        voxels = np.load(run_dir / "voxels.npz")
        assert sorted(k for k in voxels if k.endswith("_xyz")) == [f"frame{i}_xyz" for i in range(3)]
        assert len(voxels["frame0_xyz"]) > 0 and (run_dir / "voxels.html").stat().st_size > 0
        flows = np.load(run_dir / "scene_flow.npz")
        assert np.isfinite(flows["frame0_pred_flow"]).all() and len(flows["frame0_xyz"]) > 0
        assert (run_dir / "metrics_all_2.json").exists()
        return
    trainer = main(argv)
    assert [p.stem for p in run_dir.glob("data.*")] == ["data"]
    if flag == "--render_data_video_only":
        assert trainer is None and not _ckpts(run_dir)
    else:
        assert trainer.state.step == 2 and _ckpts(run_dir) == ["checkpoint_00002"]


# each setting's tiny flagship trains; "remat" and "interpolation" train
# bit for bit as the flagship without them (training never interpolates)
PORTED_SETTINGS = {"nuscenes": ["data.dataset=nuscenes", "data.pixel_source.num_cams=6",
                                "data.pixel_source.load_size=[18,32]"],
                   "sh": ["nerf.model.head.direction_encoding=sh"],
                   "interpolation": ["nerf.model.head.enable_temporal_interpolation=true"],
                   "remat": ["optim.remat=true"]}


@pytest.mark.parametrize("setting", sorted(PORTED_SETTINGS))
def test_ported_settings_train(setting, tmp_path):
    """The nuScenes loader (on a tiny devkit-layout scene), spherical-harmonics
    directions, temporal interpolation and optim.remat build and train 2
    iterations through Trainer on the tiny flagship, every loss finite."""
    import chip_smoke

    over = list(PORTED_SETTINGS[setting])
    if setting == "nuscenes":
        chip_smoke.write_nuscenes_scene(str(tmp_path / "nusc"), n_frames=4, image_hw=(36, 64),
                                        n_lidar=300)
        over.append(f"data.data_root={tmp_path / 'nusc'}")

    def train(dotlist):
        cfg = flagship_config(tiny=True, overrides=dotlist)
        trainer = Trainer(cfg, device="cpu", flow=flagship_flow_spec(cfg, tiny=True))
        metrics = [trainer.train_iteration(i) for i in range(2)]
        for m in metrics:
            assert all(np.isfinite(float(v)) for v in m.values()), m
        return trainer

    trainer = train(over)
    model = trainer.model
    if setting == "nuscenes":
        assert trainer.dataset.num_cams == 6 and trainer.dataset.lidar is not None
    if setting == "sh":
        app = model.appearance_embedding_dim if model.use_appearance_embedding else 0
        assert model.direction_encoding == "sh" and model.sky_head.layers[0].in_features == 16 + app
    if setting in ("interpolation", "remat"):
        assert model.enable_temporal_interpolation == (setting == "interpolation")
        assert trainer.step_cfg.remat == (setting == "remat")
        base = train([])
        for (name, p), q in zip(trainer.model.named_parameters(), base.model.parameters()):
            assert torch.equal(p, q), name


# the tiny flagship's dotlist, then each setting of the JAX package that
# the port took last: fine-level skipping with subsampled table gradients
# (16 proposal samples: 8 near, 8 far), the MX grid, the fused step
TINY_FLAGSHIP = list(flagship_mod._FLAGSHIP_DOTLIST) + list(flagship_mod._TINY_DOTLIST)
JAX_SETTINGS = {
    "skip_subsample": ["nerf.propnet.fine_level_skip=1", "nerf.propnet.num_samples_per_prop=[16,16]",
                       "nerf.sampling.num_samples=16", "nerf.model.perf.grad_subsample=2"],
    "mx": ["nerf.model.grid_backend=mx"],
    "fused": ["optim.fused_lidar_branch=true"],
}


@pytest.mark.parametrize("setting", sorted(JAX_SETTINGS))
def test_cli_trains_the_jax_packages_last_settings(tmp_path, setting):
    """4 iterations of the tiny flagship through the CLI with each setting,
    every logged loss finite; the final checkpoint restores the whole
    state (params and Adam moments, the MX grid's flat tables among them)
    bit for bit into a fresh trainer."""
    from emernerf_torch.train.checkpoints import latest_checkpoint, load_checkpoint

    trainer = main(_argv(tmp_path, setting) + TINY_FLAGSHIP + JAX_SETTINGS[setting] + SHORT
                   + NO_EVAL + ["render.render_full=false"])
    run_dir = tmp_path / "p" / setting
    assert trainer.state.step == 5
    records = [json.loads(x) for x in (run_dir / "metrics.json").read_text().splitlines()]
    assert records and all(np.isfinite(v) for r in records for k, v in r.items() if "loss" in k)
    if setting == "mx":
        assert trainer.model.xyz_table.dim() == 1 and trainer.prop_models[0].hash_table.dim() == 1
    if setting == "skip_subsample":
        assert trainer.prop_models[0].fine_level_skip == 1
        assert trainer.model.static_spec.grad_subsample == 2
    fresh = Trainer(trainer.cfg, device="cpu")
    load_checkpoint(latest_checkpoint(str(run_dir)), fresh.state)
    assert fresh.state.step == trainer.state.step
    for a, b in zip(fresh.state.params + fresh.state.prop_params,
                    trainer.state.params + trainer.state.prop_params):
        assert torch.equal(a, b)
    for ours, theirs in ((fresh.state.opt_state, trainer.state.opt_state),
                         (fresh.state.prop_opt_state, trainer.state.prop_opt_state)):
        assert ours.count == theirs.count
        assert all(torch.equal(a, b) for a, b in zip(ours.mu + ours.nu, theirs.mu + theirs.nu))


def test_cli_waymo_feature_head_trains_and_evaluates(tmp_path_factory, tmp_path):
    """The CLI on a Waymo-layout scene with the feature head on (the tiny
    flagship of test_torch_features): 2 iterations with the feature loss,
    then the evaluation with feat_psnr and the occupancy metrics
    (eval.eval_occ at 0.4 m), then the feature maps deleted
    (delete_features_after_run)."""
    from test_torch_features import waymo_overrides, write_scene

    from emernerf_torch.flagship import _FLAGSHIP_DOTLIST, _TINY_DOTLIST

    root = write_scene(tmp_path_factory)
    feat_dir = root / "000" / "dinov2_vitb14"
    assert len(list(feat_dir.glob("*.npy"))) == 12
    trainer = main(_argv(tmp_path, "waymo") + list(_FLAGSHIP_DOTLIST) + list(_TINY_DOTLIST)
                   + waymo_overrides(root)
                   + ["data.occ_source.voxel_size=0.4", "eval.eval_occ=true",
                      "eval.occ_annotation_stride=2", "render.render_full=false",
                      "data.pixel_source.delete_features_after_run=true",
                      "optim.num_iters=1", "logging.print_freq=1"])
    run_dir = tmp_path / "p" / "waymo"
    assert trainer.state.step == 2 and trainer.step_cfg.use_feature_loss
    records = [json.loads(x) for x in (run_dir / "metrics.json").read_text().splitlines()]
    assert np.isfinite(records[-1]["feature_loss"])
    results = json.loads((run_dir / "metrics_all_2.json").read_text())
    assert np.isfinite(results["lowres/feat_psnr"]) and np.isfinite(results["lowres/psnr"])
    occ = json.loads((run_dir / "metrics_occ_2.json").read_text())
    assert occ["num_total_points"] > 0 and set(occ["per_class_accuracy"]) >= {"vehicle", "road"}
    assert results["occ/num_total_points"] == occ["num_total_points"]
    assert not list(feat_dir.glob("*.npy"))


def test_log_every_reports_wall_clock(tmp_path):
    """The dumped per-step time is wall clock between prints, not the
    per-loop average (tests/test_train.py's check, on the port's copy)."""
    out = tmp_path / "metrics.json"
    ml = port_logging.MetricLogger(output_file=str(out))
    n, print_freq, fetch_sleep = 40, 20, 0.2
    t0 = time.time()
    for i in ml.log_every(list(range(n)), print_freq):
        if i % print_freq == print_freq - 1:
            time.sleep(fetch_sleep)
    wall_per_step = (time.time() - t0) / n
    records = [json.loads(x) for x in out.read_text().splitlines()]
    rec = next(r for r in records if r["iteration"] == 20)
    assert rec["iter_time"] == pytest.approx(wall_per_step, rel=0.5)
    assert rec["iter_time"] < fetch_sleep / 2
    assert "dispatch_time" in rec


# the JAX package's lines of data_time, and what the port has in their place
_DATA_TIME = (
    ("""    def dump_in_output_file(self, iteration, iter_time, data_time,
                            dispatch_time=None):
""", "    def dump_in_output_file(self, iteration, iter_time, dispatch_time=None):\n"),
    ("""        record = dict(
            iteration=iteration, iter_time=iter_time, data_time=data_time,
        )
""", "        record = dict(iteration=iteration, iter_time=iter_time)\n"),
    ("""        data_time = SmoothedValue(fmt="{avg:.4f}")\n""", ""),
    ("""            data_time.update(time.time() - end)\n""", ""),
    ("""                    data_time=data_time.avg,\n""", ""),
    ("""                            f"data: {data_time}",\n""", ""),
)


def test_logging_copy_equals_jax():
    """utils/logging.py is the JAX package's, but for the logger's name and
    ``MetricLogger``'s data time."""
    for name in ("_GlogFormatter", "setup_logging", "SmoothedValue", "MetricLogger"):
        ours = inspect.getsource(getattr(port_logging, name))
        ref = inspect.getsource(getattr(jax_logging, name))
        if name == "MetricLogger":
            for jax_lines, port_lines in _DATA_TIME:
                assert ref.count(jax_lines) == 1, jax_lines
                ref = ref.replace(jax_lines, port_lines)
        assert ours == ref.replace('"emernerf_tpu"', '"emernerf_torch"'), name
    name = inspect.signature(port_logging.setup_logging).parameters["name"]
    assert name.default == "emernerf_torch"


def test_wandb_init_retries_then_succeeds(tmp_path, monkeypatch):
    calls = {"n": 0}

    def flaky_init(**kwargs):
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionError("transient")

    fake = types.ModuleType("wandb")
    fake.init = flaky_init
    monkeypatch.setitem(sys.modules, "wandb", fake)
    cfg = from_dotlist(["project=test"])
    assert trainer_mod.init_wandb(cfg, str(tmp_path), retries=10, sleep_s=0.0) is fake
    assert calls["n"] == 3
    calls["n"] = 0

    def always_fail(**kwargs):
        calls["n"] += 1
        raise ConnectionError("down")

    fake.init = always_fail
    assert trainer_mod.init_wandb(cfg, str(tmp_path), retries=4, sleep_s=0.0) is None
    assert calls["n"] == 4
    # without the package: off at once, no retry
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert trainer_mod.init_wandb(cfg, str(tmp_path), retries=4, sleep_s=0.0) is None
