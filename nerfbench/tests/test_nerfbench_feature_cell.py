"""The ``feature-train`` cell (EmerNeRF's feature lifting on the flagship) at
the tiny size on the CPU: a run is correct with the feature loss on both
sides and compares the rendered feature (``dino_feat``,
``drivers/train_features.py``); each fault confined to the feature head,
planted in the program, comes out not correct at the cell's limits, and so
do the control and the half batch of ``calibrate_features.py``; the cell's
two readers (``train_feature_host_ms_per_it``,
``k3_wide_roofline_pct``) read a feature run and not a flagship-train run;
K3's least bytes of one wide call by hand.  The card test runs the tiny
cell traced on the card, where K3's kernels run."""

import ast
import contextlib
import io
import re
import sys

import pytest
import torch

from nerfbench import harness, trace
from nerfbench.counts import composite
from nerfbench.tests import tiny

CELL = "feature-train"
# the tiny scene's maps: a (3, 5) patch grid of the cell's 64 channels, so
# that the composite takes K3's wide route (3 + 1 + 64 = 68 channels)
TINY_MAPS = {"data.pixel_source.feature_extraction_size": [28, 42]}
READERS = ("train_feature_host_ms_per_it", "k3_wide_roofline_pct")


# --------------------------------------------------------------------------- #
# faults confined to the feature head, planted in the program's path
def _pe_coordinates_swapped(monkeypatch):
    """The learnable PE map sampled with its two coordinates swapped."""
    from emernerf_torch.models import fields

    orig = fields.grid_sample_2d
    monkeypatch.setattr(fields, "grid_sample_2d", lambda image, gx, gy: orig(image, gy, gx))


def _patched_composite(monkeypatch, change):
    from emernerf_torch.render import renderer

    orig = renderer.composite_rays

    def composite_rays(t_starts, t_ends, results, **kw):
        return orig(t_starts, t_ends, change(dict(results)), **kw)

    monkeypatch.setattr(renderer, "composite_rays", composite_rays)


def _dynamic_dino_under_static_density(monkeypatch):
    """The dynamic branch's DINO output mixed in by the static density's
    share, not the dynamic density's."""
    def change(results):
        if "dynamic_dino_feat" in results:
            share = results["static_density"] / (results["density"] + 1e-6)
            results["dino_feat"] = share[..., None] * (results.pop("static_dino_feat")
                                                       + results.pop("dynamic_dino_feat"))
        return results

    _patched_composite(monkeypatch, change)


def _sky_feature_left_out(monkeypatch):
    """The sky feature head's output left out of the composite."""
    def change(results):
        results.pop("dino_sky_feat", None)
        return results

    _patched_composite(monkeypatch, change)


class _Fp8(torch.autograd.Function):
    """fp8 training's rounding, as the control rounds (``plain/ops/lowp.py``):
    e4m3 on the way forward, e5m2 on the way back, each tensor scaled to its
    largest magnitude."""

    @staticmethod
    def forward(ctx, x):
        from nerfbench.reference.plain.ops import lowp

        return lowp._round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        from nerfbench.reference.plain.ops import lowp

        return lowp._round(g, torch.float8_e5m2)


def _dino_head_in_fp8(monkeypatch):
    """The DINO head's output rounded as fp8 training rounds it."""
    from emernerf_torch.models import fields

    orig = fields.RadianceField.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        if getattr(self, "enable_feature_head", False):
            self.dino_head.register_forward_hook(lambda module, inputs, out: _Fp8.apply(out))

    monkeypatch.setattr(fields.RadianceField, "__init__", init)


HEAD_FAULTS = [_pe_coordinates_swapped, _dynamic_dino_under_static_density,
               _sky_feature_left_out, _dino_head_in_fp8]


# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def _traced_readers():
    """The cell's two readers loaded (so their wrappings are installed) and
    each traced training run's trace kept; every wrapping undone on the way
    out."""
    mp = pytest.MonkeyPatch()
    mp.setattr(trace, "profile_span", trace.profile_span)
    mp.setattr(trace, "breakdown", trace.breakdown)
    traces = []
    mp.setattr(trace, "resolve_grid_calls",
               lambda tr, resolve=trace.resolve_grid_calls: traces.append(tr) or resolve(tr))
    loaded = set(sys.modules)
    try:
        for name in READERS:
            harness.load_module("metrics", f"{name}.py")
        yield traces
    finally:
        mp.undo()
        for name in set(sys.modules) - loaded:
            if name.startswith("nerfbench._by_name."):
                del sys.modules[name]


def _run(cell, trace_on, extra=None):
    """(exit code, last line, harness stderr, the window's own stderr) of one tiny run."""
    mp = pytest.MonkeyPatch()
    window_err = io.StringIO()
    try:
        with contextlib.redirect_stderr(window_err):
            rc, line, err = tiny.run_tiny(mp, cell, trace=trace_on, extra=extra)
    finally:
        mp.undo()
    return rc, line, err, window_err.getvalue()


@pytest.fixture(scope="module")
def traced():
    """One tiny traced run of feature-train and one of flagship-train, with
    both readers loaded: {cell: (exit code, last line, stderr, trace)}."""
    threads = torch.get_num_threads()
    out = {}
    try:
        with _traced_readers() as traces:
            for cell, extra in ((CELL, TINY_MAPS), ("flagship-train", None)):
                n = len(traces)
                rc, line, err, window_err = _run(cell, 1, extra)
                out[cell] = (rc, line, err + window_err, traces[n] if len(traces) > n else None)
    finally:
        torch.set_num_threads(threads)
    return out


def test_a_feature_cell_run_is_correct_with_the_feature_loss_on(traced):
    from emernerf_torch.render import renderer
    from emernerf_torch.render.volrend import composite_rays

    rc, line, err, _ = traced[CELL]
    assert rc == 0, err
    assert line["correct"] is True, line["compared"]
    assert set(line["compared"]) == {"grad", "change", "grad_diff", "dino_feat"}
    # float32 on both sides at the tiny size: the same feature to rounding
    assert line["compared"]["dino_feat"]["value"] < 1e-5
    # the window ran the program's own composite
    assert renderer.composite_rays is composite_rays
    m = re.search(r"feature_loss of the compared iterations: program (\[.*?\]), "
                  r"reference (\[.*?\])", err)
    assert m, err
    prog, ref = ast.literal_eval(m.group(1)), ast.literal_eval(m.group(2))
    assert len(prog) == len(ref) == harness.load_workload(CELL)["compared_iterations"]
    assert all(v > 0 for v in prog + ref)


@pytest.mark.parametrize("fault", HEAD_FAULTS, ids=[f.__name__[1:] for f in HEAD_FAULTS])
def test_a_fault_in_the_feature_head_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    rc, line, err, _ = _run(CELL, 0, TINY_MAPS)
    assert rc == 0, err
    assert line["correct"] is False, line["compared"]


def test_the_calibration_reads_the_control_and_the_half_batch_not_correct(monkeypatch,
                                                                          capsys):
    import json

    from nerfbench import calibrate_features

    wl, cfg = tiny.tiny_cell(CELL, TINY_MAPS)
    orig_json = harness.load_json
    monkeypatch.setattr(harness, "load_workload", lambda c: wl)
    monkeypatch.setattr(harness, "load_json",
                        lambda *p: cfg if p[0] == "configs" else orig_json(*p))
    threads = torch.get_num_threads()
    try:
        assert calibrate_features.main(["--workload", CELL, "--seeds", str(2 ** 31 + 17),
                                        "--cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["feed_check"] == []
    drv = harness.load_module("drivers", "train_features.py")
    for side, nums in out["readings"].items():
        ok = all(c.ok for c in drv.checks(nums, wl["limits"]))
        assert ok is (side == "program"), (side, nums)
    # the half batch renders the rays it shares with the reference alike
    assert out["readings"]["half_batch"]["dino_feat"] < 1e-5
    assert out["readings"]["control"]["dino_feat"] > wl["limits"]["dino_feat"]


def test_the_readers_read_a_feature_run_and_not_a_flagship_run(traced):
    rc, line, err, tr = traced[CELL]
    assert rc == 0, err
    assert line["metrics"]["train_feature_host_ms_per_it"]["value"] > 0
    # the CPU launches no K3 kernel: the wide calls are recorded, not read
    assert "k3_wide_roofline_pct" not in line["metrics"]
    calls = tr["span"]["k3_calls"]
    wide = [c for c in calls if composite.is_wide(c["c"])]
    assert {(c["c"], c["backward"]) for c in wide} == {(68, False), (68, True)}
    rc, flagship, err, flagship_tr = traced["flagship-train"]
    assert rc == 0, err
    assert not set(READERS) & set(flagship["metrics"])
    with _traced_readers():
        reader = harness.load_module("metrics", "k3_wide_roofline_pct.py")
        feature_reader = harness.load_module("metrics", "train_feature_host_ms_per_it.py")
    assert feature_reader.read(flagship_tr) is None
    assert not any(composite.is_wide(c["c"]) for c in flagship_tr["span"]["k3_calls"])
    # the recorded calls' launches as the card names them, each taking twice
    # its least time (the weights' launch and the sums' a half each): 50%
    intervals, t = [], 0
    for c in calls:
        least = 1e9 * composite.least_seconds(c)
        if c["backward"]:
            names = [("composite_bwd_kernel<1, false>", 2 * least)]
        elif composite.is_wide(c["c"]):
            names = [("composite_warp_kernel<1>", least), ("composite_sums_kernel", least)]
        else:
            names = [("composite_warp_kernel<1>", 1000)]
        for name, ns in names:
            intervals.append((t, t + ns, name))
            t += ns + 10
    for card_tr in (dict(tr, span=dict(tr["span"], intervals_ns=intervals)),
                    dict(flagship_tr, span=dict(flagship_tr["span"], intervals_ns=intervals))):
        got = reader.read(card_tr)
        if card_tr["span"]["k3_calls"] is calls:
            assert got == pytest.approx(50.0, rel=1e-6)
        else:
            assert got is None
    # a launch the profiler lost: the launches and the calls do not pair
    lost = dict(tr, span=dict(tr["span"], intervals_ns=intervals[1:]))
    assert reader.read(lost) is None


def test_composite_bytes_of_one_wide_call_by_hand():
    r, s, d, c = 2, 3, 1, 65
    # forward: t_starts, t_ends (r s each), densities (r s d), values (r s c);
    # weights, trans (r s d each), opacity, depth (r d each), median (r), sums (r c)
    fwd = 4 * (6 + 6 + 6 + 6 * 65 + 12 + 4 + 2 + 130)
    assert composite.bytes_moved(r, s, d, c, False) == fwd
    # backward with the opacity's and the sums' cotangents: the inputs, those
    # two (r d, r c); d densities (r s d), d values (r s c)
    bwd = 4 * (6 + 6 + 6 + 390 + 2 + 130 + 6 + 390)
    assert composite.bytes_moved(r, s, d, c, True, ("opacity", "sums")) == bwd
    call = dict(r=r, s=s, d=d, c=c, backward=True, cotangents=("opacity", "sums"))
    assert composite.least_seconds(call) == pytest.approx(
        max(composite.ops(r, s, d, c, True) / 67e12, bwd / 3.35e12))
    assert composite.is_wide(65) and not composite.is_wide(64)


@pytest.mark.cuda
def test_the_readers_read_a_tiny_feature_run_on_the_card():
    """The tiny cell traced on the card: correct, and both
    readers read, the roofline share in (0, 100]."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    mp = pytest.MonkeyPatch()
    try:
        with _traced_readers():
            rc, line, err = tiny.run_tiny(mp, CELL, trace=1, device="cuda", extra=TINY_MAPS)
    finally:
        mp.undo()
    assert rc == 0, err
    assert line["correct"] is True, line["compared"]
    assert line["metrics"]["train_feature_host_ms_per_it"]["value"] > 0
    assert 0 < line["metrics"]["k3_wide_roofline_pct"]["value"] <= 100
