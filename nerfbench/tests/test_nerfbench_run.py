"""Whole runs of every cell at the tiny size on the CPU, the harness's look
for a card skipped: the last line's keys, a correct run, and each fault a
cell can have, planted in the timed path, coming out not correct; the
control (the reference in a lower precision in the program's place) too."""

import json
import os
import subprocess
import sys

import pytest
import torch

from nerfbench import harness
from nerfbench.tests import tiny

ROOT = tiny.harness.HERE.rsplit(os.sep, 1)[0]
TRAIN = ("flagship-train", "hash-train")
CELLS = TRAIN + ("flagship-eval",)
KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct_and_its_last_line_has_the_keys(monkeypatch, cell):
    rc, line, err = tiny.run_tiny(monkeypatch, cell)
    assert rc == 0, err
    assert set(line) == KEYS and list(line)[-1] == "compared"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    bench = harness.manifest()
    want = {m["name"] for m in harness.cell_metrics(bench, cell, "end_to_end")}
    assert set(line["metrics"]) == want
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    # the numbers compared close standard error, each beside its limit
    tail = err.strip().splitlines()[-len(line["compared"]):]
    assert all(t.startswith("compared ") and " limit " in t for t in tail)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_the_per_layer_metrics(monkeypatch, cell):
    rc, line, err = tiny.run_tiny(monkeypatch, cell, trace=1)
    assert rc == 0, err
    assert set(line) == KEYS | {"breakdown"}
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())
    bench = harness.manifest()
    allowed = {m["name"] for m in harness.cell_metrics(bench, cell, "per_layer")}
    assert set(line["metrics"]) <= allowed and line["metrics"]


def _unchanged_state(monkeypatch):
    from emernerf_torch.train import step

    monkeypatch.setattr(step, "apply_update", lambda *a, **k: None)


def _half_batch(monkeypatch):
    from emernerf_torch.train import step

    def halved(orig):
        def fn(self, batch, draws, *a, **k):
            cut = lambda x: x[: x.shape[0] // 2] if torch.is_tensor(x) and x.ndim else x
            batch = {key: cut(v) for key, v in batch.items()}
            draws = type(draws)(tuple(cut(j) for j in draws.jitters), cut(draws.topk_u),
                                cut(draws.agg_noise))
            return orig(self, batch, draws, *a, **k)
        return fn

    monkeypatch.setattr(step.TrainStep, "pixel_loss", halved(step.TrainStep.pixel_loss))
    monkeypatch.setattr(step.TrainStep, "lidar_loss", halved(step.TrainStep.lidar_loss))


def _altered_answer(monkeypatch):
    from emernerf_torch.train import step

    orig = step.render_ray_batch

    def altered(*a, **k):
        res = orig(*a, **k)
        out = dict(res.out)
        if "rgb" in out:
            out["rgb"] = out["rgb"] * 0.9
        else:
            out["depth"] = out["depth"] * 0.9
        return res._replace(out=out)

    monkeypatch.setattr(step, "render_ray_batch", altered)


def _eval_altered(monkeypatch):
    from emernerf_torch.eval.renderer import ImageRenderer

    orig = ImageRenderer.render_chunk

    def altered(self, rays, is_lidar=False):
        out = orig(self, rays, is_lidar)
        out["rgb"] = out["rgb"] + 0.01
        return out

    monkeypatch.setattr(ImageRenderer, "render_chunk", altered)


def _eval_half(monkeypatch):
    from emernerf_torch.eval.renderer import ImageRenderer

    orig = ImageRenderer.render_chunk

    def halved(self, rays, is_lidar=False):
        n = rays["origins"].shape[0]
        out = orig(self, {k: v[: n // 2] for k, v in rays.items()}, is_lidar)
        return {k: torch.cat([v, v[: n - n // 2]]) for k, v in out.items()}

    monkeypatch.setattr(ImageRenderer, "render_chunk", halved)


FAULTS = [(c, f) for c in TRAIN for f in (_unchanged_state, _half_batch, _altered_answer)]
FAULTS += [("flagship-eval", f) for f in (_eval_altered, _eval_half)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, line, err = tiny.run_tiny(monkeypatch, cell)
    assert rc == 0, err
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(monkeypatch, cell):
    """The reference computed in fp8 (e4m3 forward, e5m2 backward), put in
    the program's place, fails the cell's limits."""
    checks = tiny.control_checks(cell)
    assert not all(c.ok for c in checks), checks


def test_no_card_no_result(monkeypatch):
    """Without a card the run exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc, line, err = tiny.run_tiny(monkeypatch, "flagship-train", device=None)
    assert rc != 0 and line is None and "cuda" in err.lower()


def test_a_directory_of_the_benchmark_alone_gives_no_result(tmp_path):
    """Only BENCHMARK.json and nerfbench/: the run fails and prints no result."""
    subprocess.run(["cp", "-r", os.path.join(ROOT, "nerfbench"), str(tmp_path)], check=True)
    subprocess.run(["cp", os.path.join(ROOT, "BENCHMARK.json"), str(tmp_path)], check=True)
    p = subprocess.run([sys.executable, "nerfbench/run.py", "--workload", "flagship-train",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    """One short run of flagship-train on the card (run on the chip)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "nerfbench/run.py", "--workload", "flagship-train",
                        "--seed", str(2 ** 31 + 5), "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
