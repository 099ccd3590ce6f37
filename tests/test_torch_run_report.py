"""The port's run report and quality harness against the repository's
originals, on the CPU: ``emernerf_torch/perf/northstar_report.py`` against
``perf/northstar_report.py`` on a hand-made run directory (byte for byte),
``quality_report.py``'s rows against the original's verdicts on a hand-made
results file, ``quality_ab.py``'s variant table against the original's, a
tiny ``run_variant`` on the CPU into a temporary file, and the training
CLI writing the report into its run directory after training and after
``--eval_only``, and not after a preemption.
"""

import builtins
import json
import os
import signal
import sys

import pytest
import torch
from test_cli import TINY_OVERRIDES

import perf.northstar_report as jax_northstar
import perf.quality_ab as jax_quality_ab
import perf.quality_report as jax_quality_report
from emernerf_torch.perf import northstar_report, quality_ab, quality_report
from emernerf_torch.train import trainer as trainer_mod
from emernerf_torch import train_emernerf as cli
from emernerf_torch.train_emernerf import main

SHORT = ["optim.num_iters=2", "logging.print_freq=1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_dir(root):
    """A run directory as the trainer leaves it: JSON-lines metrics with a
    torn last line and a line without PSNR, the eval files, checkpoints."""
    run = root / "p" / "r5"
    (run / "videos").mkdir(parents=True)
    lines = [json.dumps({"iteration": i, "psnr": 20.0 + i / 7, "range_rmse": 3.0 - i / 11,
                         "rgb_loss": 0.01 / (i + 1), "iter_time": 0.05 + i / 1000})
             for i in range(0, 40, 3)]
    lines.insert(3, json.dumps({"iteration": 7, "lr": 0.01}))
    lines.append(json.dumps({"iteration": 41, "psnr": 26.5, "rgb_loss": 0.002}))
    (run / "metrics.json").write_text("\n".join(lines) + '\n{"iteration": 4')
    (run / "metrics_test_40.json").write_text(json.dumps(
        {"psnr": 24.25, "ssim": 0.81234567, "non_masked_psnr": 24.25}))
    (run / "metrics_lowres_40.json").write_text(json.dumps({"psnr": 25.5, "ssim": 0.9}))
    (run / "metrics_all_40.json").write_text(json.dumps(
        {"test/psnr": 24.25, "lidar/depth_rmse": 1.5, "count": 3, "name": "x"}))
    for step in (20, 40):
        (run / f"checkpoint_{step:05d}").mkdir()
    for i in range(6):
        (run / "videos" / f"lowres_{i}.gif").write_bytes(b"")
    return run


def test_build_report_is_the_originals(tmp_path):
    run = str(_run_dir(tmp_path))
    ours = northstar_report.build_report(run)
    assert ours == jax_northstar.build_report(run)
    for section in ("Training curve", "Test-split eval", "Low-res eval", "Final evaluation",
                    "checkpoint_*: 2", "videos/*: 6"):
        assert section in ours, section
    assert northstar_report.build_report(str(tmp_path / "none")) == \
        jax_northstar.build_report(str(tmp_path / "none"))


def test_write_report_writes_into_the_run(tmp_path, capsys):
    run = _run_dir(tmp_path)
    out = northstar_report.write_report(str(run))
    assert out == str(run / "NORTHSTAR_r5.md")
    # the report itself is not part of the next report's inventory
    assert (run / "NORTHSTAR_r5.md").read_text() == northstar_report.build_report(str(run))
    other = tmp_path / "elsewhere.md"
    northstar_report.main([str(run), "--out", str(other)])
    assert other.read_text() == (run / "NORTHSTAR_r5.md").read_text()
    assert f"wrote {other}" in capsys.readouterr().out


def _curve(steps, psnr0, rmse0, every=100, ms=None):
    return [{"step": s, "psnr": round(psnr0 + s / 1000, 3), "range_rmse": round(rmse0 - s / 5000, 3),
             **({"t": round(s * ms / 1000, 1)} if ms else {})}
            for s in range(every, steps + 1, every)]


def _row(steps, psnr0, rmse0, ms=None, era=None, done=None, every=100):
    curve = _curve(done or steps, psnr0, rmse0, every, ms)
    row = {"steps": steps, "curve": curve}
    if ms:
        row["steady_ms_per_step"] = ms
    if era:
        row["defaults_era"] = era
    return row


RESULTS = {
    "base": _row(2500, 31.0, 0.4, ms=1400.0),
    "sub4": _row(2500, 30.7, 0.41, ms=1500.0),
    "topk0": _row(2500, 31.5, 1.4, done=1400),
    "stopk32l16": _row(2500, 31.2, 0.7, ms=1000.0),
    "stagedl16": _row(2500, 31.4, 0.3, ms=980.0),
    "mx": _row(2500, 29.0, 1.2, ms=800.0),
    "brick4k": _row(1000, 30.5, 0.9, ms=600.0),
    "hash4k": _row(1000, 30.1, 0.95, ms=8800.0),
    "pixstack": _row(2500, 31.2, 0.28, ms=890.0, era="staged"),
    "finelvl2": _row(2500, 27.0, 5.8, era="staged", done=200),
    "hash": {"steps": 2500, "curve": []},
    "refsem4k2500": _row(2500, 31.0, 1.0, ms=1700.0),  # its base, brick4k2500, is missing
}


def _original_rows(tmp_path, monkeypatch, results):
    """The original's verdicts on ``results``: its ``open`` reads the file
    from ``tmp_path`` and writes its verdicts there."""
    src, dst = tmp_path / "QUALITY_r02.json", tmp_path / "QUALITY_VERDICTS.json"
    src.write_text(json.dumps(results))

    def redirected(path, *a, **kw):
        name = os.path.basename(path)
        return builtins.open({"QUALITY_r02.json": src, "QUALITY_VERDICTS.json": dst}[name],
                             *a, **kw)

    monkeypatch.setattr(jax_quality_report, "open", redirected, raising=False)
    monkeypatch.setattr(sys, "argv", ["quality_report.py", "--json"])
    jax_quality_report.main()
    return json.loads(dst.read_text())


def test_quality_report_rows_are_the_originals(tmp_path, monkeypatch, capsys):
    theirs = _original_rows(tmp_path, monkeypatch, RESULTS)
    assert theirs and "hash4k" in theirs and "stagedl16" in theirs
    ours = quality_report.build_rows(RESULTS)
    for name, row in theirs.items():
        assert {k: ours[name][k] for k in row} == row, name
    # rows the original skips are printed without the base columns
    skipped = set(ours) - set(theirs)
    assert skipped == {"brick4k", "refsem4k2500"}
    assert ours["brick4k"]["base"] is None and "d_psnr_vs_base" not in ours["brick4k"]
    assert "hash" not in ours  # no curve
    for name in ("R3_VARIANTS", "BASE_OVERRIDE", "PAIR_BASES"):
        assert getattr(quality_report, name) == getattr(jax_quality_report, name), name


def test_quality_report_sets_each_row_beside_the_jax_record(tmp_path, capsys):
    reference = {"stagedl16": _row(2500, 31.5, 0.31, ms=985.4),
                 "brick4k": _row(1000, 30.4, 0.95, ms=675.1),
                 "mx": {"steps": 2500, "curve": []}}
    ours = {"stagedl16": _row(2500, 31.4, 0.3, ms=90.0, done=1500),
            "brick4k": _row(1000, 30.5, 0.9, ms=50.0),
            "mx": _row(2500, 29.0, 1.2, ms=190.0)}
    ours["stagedl16"]["curve"][-1]["psnr"] -= 0.5  # a late gap
    rows = quality_report.build_rows(ours, reference)
    s = rows["stagedl16"]
    assert s["jax_step"] == 1500 and s["jax_psnr"] == pytest.approx(33.0)
    assert s["d_psnr_vs_jax"] == pytest.approx(-0.6) and not s["within_0p3_db_of_jax"]
    assert s["max_abs_d_psnr_vs_jax_from_1000"] == pytest.approx(0.6)
    assert s["range_rmse_at_jax_step"] == ours["stagedl16"]["curve"][-1]["range_rmse"]
    b = rows["brick4k"]
    assert b["jax_step"] == 1000 and b["within_0p3_db_of_jax"]
    assert b["max_abs_d_psnr_vs_jax_from_1000"] == pytest.approx(0.1)
    assert "jax_step" not in rows["mx"]  # the JAX row has no curve
    res, ref = tmp_path / "ours.json", tmp_path / "ref.json"
    res.write_text(json.dumps(ours))
    ref.write_text(json.dumps(reference))
    printed = quality_report.main(["--results", str(res), "--reference", str(ref),
                                   "--json", str(tmp_path / "rows.json")])
    assert printed == json.loads((tmp_path / "rows.json").read_text())
    out = capsys.readouterr().out
    assert "stagedl16" in out and "985.4" not in out  # no time of the JAX record


def test_variants_are_the_originals():
    ours, theirs = quality_ab.VARIANTS, jax_quality_ab.VARIANTS
    assert list(ours) == list(theirs)
    assert quality_ab._TIMEPAIR0 == jax_quality_ab._TIMEPAIR0
    assert set(quality_ab.REFUSED) == {"onehot0"}
    for name, overrides in theirs.items():
        if name in quality_ab._TIMEPAIR0:
            assert ours[name] == overrides + [quality_ab.TIME_PAIR_OFF], name
        else:
            assert ours[name] == overrides, name
    with pytest.raises(ValueError, match="TPU lowering knob"):
        quality_ab.run_variant("onehot0", 2, device="cpu", out="unused")
    with pytest.raises(ValueError, match="TPU lowering knob"):
        quality_ab.main(["--variant", "onehot0", "--device", "cpu"])
    with pytest.raises(ValueError, match="card rows only"):
        quality_ab.run_variant("stagedl16", 2, device="cpu")


def test_run_variant_writes_the_originals_row(tmp_path, capsys):
    out = str(tmp_path / "q.json")
    (tmp_path / "q.json").write_text(json.dumps({"other": {"steps": 1, "curve": []}}))
    row = quality_ab.run_variant("stagedl16", 20, eval_window=5, record_every=10,
                                 device="cpu", tiny=True, out=out)
    saved = json.loads((tmp_path / "q.json").read_text())
    assert set(saved) == {"other", "stagedl16"} and saved["stagedl16"] == row
    assert set(row) >= {"steps", "steps_done", "partial", "wall_s",
                        "wall_ms_per_step_incl_compile", "steady_ms_per_step", "final_psnr",
                        "final_range_rmse", "curve", "defaults_lidar_topk_until",
                        "defaults_era"}
    assert row["steps"] == row["steps_done"] == 20 and row["partial"] is False
    assert [c["step"] for c in row["curve"]] == [10, 20]
    assert row["final_psnr"] == row["curve"][-1]["psnr"] > 0
    assert row["defaults_era"] == "staged" and row["defaults_lidar_topk_until"] == 0.9
    assert row["card"] is None and row["device"] == "cpu" and row["seed"] == 0
    assert row["steady_ms_per_step"] > 0
    again = quality_ab.run_variant("stagedl16", 10, eval_window=5, record_every=10,
                                   device="cpu", tiny=True, out=out, seed=1)
    saved = json.loads((tmp_path / "q.json").read_text())
    assert set(saved) == {"other", "stagedl16", "stagedl16/seed1"}
    assert again["seed"] == 1 and again["final_psnr"] != row["curve"][0]["psnr"]
    # beside the same JAX row, and against the seed-0 row
    rows = quality_report.build_rows(saved, {"stagedl16": _row(20, 15.0, 5.0, every=10)})
    assert rows["stagedl16/seed1"]["base"] == "stagedl16"
    assert (rows["stagedl16/seed1"]["jax_step"], rows["stagedl16"]["jax_step"]) == (10, 20)
    brick = quality_report.build_rows({"brick4k": _row(1000, 30.5, 0.9),
                                       "brick4k/seed1": _row(1000, 30.2, 1.6)})
    assert brick["brick4k/seed1"]["base"] == "brick4k" and brick["brick4k"]["base"] is None
    # a variant with another setting on top, under a name of its own
    with pytest.raises(ValueError, match="row name of its own"):
        quality_ab.run_variant("stagedl16", 10, device="cpu", tiny=True, out=out,
                               extra=["nerf.sampling.lidar_topk_until=1.0"])
    ab = quality_ab.run_variant("stagedl16", 10, eval_window=5, record_every=10, device="cpu",
                                tiny=True, out=out, extra=["nerf.sampling.lidar_topk_until=1.0"],
                                row="stagedl16_nostage")
    assert ab["defaults_era"] == "prestaged" and ab["defaults_lidar_topk_until"] == 1.0
    assert ab["variant"] == "stagedl16" and ab["extra"] == ["nerf.sampling.lidar_topk_until=1.0"]
    saved = json.loads((tmp_path / "q.json").read_text())
    rows = quality_report.build_rows(saved, {"stagedl16": _row(20, 15.0, 5.0, every=10)})
    assert rows["stagedl16_nostage"]["base"] == "stagedl16"
    assert "jax_step" not in rows["stagedl16_nostage"]  # another config than the JAX row's


def _argv(tmp_path, run, *flags):
    return ["--device", "cpu", "--output_root", str(tmp_path), "--project", "p",
            "--run_name", run, *flags]


def test_cli_writes_the_run_report_after_training_and_eval_only(tmp_path, monkeypatch):
    run_dir = tmp_path / "p" / "r"
    dotlist = TINY_OVERRIDES + SHORT + ["data.pixel_source.test_image_stride=2",
                                        "render.render_test=true"]
    main(_argv(tmp_path, "r") + dotlist)
    report = (run_dir / "NORTHSTAR_r.md").read_text()
    assert report == northstar_report.build_report(str(run_dir))
    assert "Test-split eval (`metrics_test_3.json`)" in report
    assert "- checkpoint_*: 1 (checkpoint_00003)" in report

    os.remove(run_dir / "NORTHSTAR_r.md")
    main(_argv(tmp_path, "r", "--eval_only") + dotlist)
    assert (run_dir / "NORTHSTAR_r.md").read_text() == report

    # a failing report is a warning: the run is finished
    def broken(run):
        raise OSError("disk full")

    warned = []
    monkeypatch.setattr(cli, "write_report", broken)
    monkeypatch.setattr(cli.logger, "warning", lambda msg, *a: warned.append(msg % a))
    trainer = main(_argv(tmp_path, "r", "--eval_only") + dotlist)
    assert trainer.state.step == 3
    assert warned == ["run report generation failed: disk full"]


def test_cli_writes_no_run_report_after_a_preemption(tmp_path, monkeypatch):
    before = signal.getsignal(signal.SIGTERM)
    real = trainer_mod.Trainer.train_iteration

    def signaling(self, step):
        out = real(self, step)
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(trainer_mod.Trainer, "train_iteration", signaling)
    trainer = main(_argv(tmp_path, "pre") + TINY_OVERRIDES + SHORT)
    assert trainer.preempted and signal.getsignal(signal.SIGTERM) is before
    run_dir = tmp_path / "p" / "pre"
    assert [p.name for p in run_dir.glob("checkpoint_*")] == ["checkpoint_00002"]
    assert not list(run_dir.glob("NORTHSTAR_*"))
