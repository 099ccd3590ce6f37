"""A training cell with EmerNeRF's feature lifting at the tiny size on the
CPU: the program and the reference both train on the scene's feature maps,
the fed feature targets are checked against the scene, and a wrong row, a
fault in the timed path or the control comes out not correct."""

import ast
import re

import pytest
import torch

from nerfbench import harness
from nerfbench.reference import compare
from nerfbench.tests import tiny
from nerfbench.tests.test_nerfbench_run import _half_batch

CELL = "flagship-train"


@pytest.fixture(scope="module")
def fed():
    """The compared iterations of a tiny feature run: (feeds, lidar draws,
    the scene's tables, the batch size)."""
    wl, cfg = tiny.tiny_cell(CELL, tiny.TINY_FEATURES)
    ctx = harness.Ctx(CELL, wl, cfg, 2 ** 31 + 13, 0.0, False, torch.device("cpu"), 0.0)
    s = harness.load_module("drivers", "train.py").compared_setup(ctx)
    assert s["reasons"] == []
    return (s["feeds"], s["lidar_draws"], s["facts"].tables,
            int(wl["overrides"]["data.ray_batch_size"]))


def _with_features(feeds, make):
    out = []
    for f in feeds:
        px = dict(f["pixel"])
        px["features"] = make(px)
        out.append(dict(f, pixel=px))
    return out


def _cells(tables, px):
    h, w = tables.images.shape[1:3]
    fh, fw = tables.features.shape[1:3]
    y = torch.round(px["pixel_coords"][:, 0] * h).long()
    x = torch.round(px["pixel_coords"][:, 1] * w).long()
    return px["img_idx"].long(), (y * fh) // h, (x * fw) // w


def test_the_fed_feature_targets_are_the_scenes(fed):
    feeds, draws, tables, n = fed
    assert all("features" in f["pixel"] for f in feeds)
    assert compare.check_feeds(feeds, draws, tables, n) == []


def test_feature_rows_of_another_image_are_reported(fed):
    feeds, draws, tables, n = fed

    def other_image(px):
        img, fy, fx = _cells(tables, px)
        return tables.features[(img + 1) % tables.features.shape[0], fy, fx]

    bad = compare.check_feeds(_with_features(feeds, other_image), draws, tables, n)
    assert len(bad) == len(feeds)
    assert all(r.endswith("feature targets that are not the scene's") for r in bad)


def test_feature_rows_of_another_cell_are_reported(fed):
    feeds, draws, tables, n = fed

    def other_cell(px):
        img, fy, fx = _cells(tables, px)
        return tables.features[img, fy, (fx + 1) % tables.features.shape[2]]

    bad = compare.check_feeds(_with_features(feeds, other_cell), draws, tables, n)
    assert len(bad) == len(feeds)
    assert all(r.endswith("feature targets that are not the scene's") for r in bad)


def test_a_batch_without_feature_targets_is_reported(fed):
    feeds, draws, tables, n = fed
    bare = [dict(f, pixel={k: v for k, v in f["pixel"].items() if k != "features"})
            for f in feeds]
    bad = compare.check_feeds(bare, draws, tables, n)
    assert len(bad) == len(feeds) and all("without feature targets" in r for r in bad)


def test_a_feature_run_is_correct_with_the_feature_loss_on(monkeypatch, capsys):
    rc, line, err = tiny.run_tiny(monkeypatch, CELL, extra=tiny.TINY_FEATURES)
    assert rc == 0, err
    assert line["correct"] is True, line["compared"]
    # the driver's own lines go to the process's standard error
    driver_err = capsys.readouterr().err
    m = re.search(r"feature_loss of the compared iterations: program (\[.*?\]), "
                  r"reference (\[.*?\])", driver_err)
    assert m, driver_err
    prog, ref = ast.literal_eval(m.group(1)), ast.literal_eval(m.group(2))
    n = harness.load_workload(CELL)["compared_iterations"]
    assert len(prog) == len(ref) == n
    assert all(v > 0 for v in prog + ref)


def _wrong_feature_row(monkeypatch):
    """The pixel batch's feature targets shifted by one row where the
    sampler makes them."""
    from emernerf_torch.train import trainer as trainer_mod

    orig = trainer_mod.sample_pixel_batch

    def shifted(*a, **k):
        batch = orig(*a, **k)
        batch["features"] = batch["features"].roll(1, 0)
        return batch

    monkeypatch.setattr(trainer_mod, "sample_pixel_batch", shifted)


@pytest.mark.parametrize("fault", [_half_batch, _wrong_feature_row],
                         ids=["half_batch", "wrong_feature_row"])
def test_a_fault_in_a_feature_run_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    rc, line, err = tiny.run_tiny(monkeypatch, CELL, extra=tiny.TINY_FEATURES)
    assert rc == 0, err
    assert line["correct"] is False, line["compared"]


def test_the_control_of_a_feature_run_is_not_correct():
    checks = tiny.control_checks(CELL, tiny.TINY_FEATURES)
    assert not all(c.ok for c in checks), checks
