"""The program's spans in a traced run (``nerfbench/spans.py``): a planted
host delay reads as an idle gap put down to its span, on the profiler's
clock; the idle split and the gap names on hand-made intervals; the
readers of the span metrics; a tiny traced run prints them and reads every
other metric as it did without the spans."""

import sys
import time

import pytest
import torch

from emernerf_torch.utils.trace import Record
from nerfbench import harness, spans, trace
from nerfbench.tests import tiny

TRAIN = {"train_sample_host_ms_per_it": ("trainer.sample", ""),
         "train_render_host_ms_per_it": ("render", "step."),
         "train_backward_host_ms_per_it": ("step.backward", ""),
         "adam_host_ms_per_it": ("optim.update", "")}
EVAL = {"eval_rays_host_ms_per_frame": "eval.rays",
        "eval_fetch_ms_per_frame": "eval.fetch",
        "eval_metrics_host_ms_per_frame": "eval.metrics"}
NEW = list(TRAIN) + list(EVAL)


@pytest.fixture(autouse=True)
def installed(monkeypatch):
    """A traced run's wrapping of ``trace.profile_span`` and ``breakdown``,
    undone after each test; the metric readers loaded in the test (whose
    import installs it) are dropped with it, so a later load installs it
    again."""
    monkeypatch.setattr(trace, "profile_span", trace.profile_span)
    monkeypatch.setattr(trace, "breakdown", trace.breakdown)
    loaded = set(sys.modules)
    spans.install()
    yield
    for name in set(sys.modules) - loaded:
        if name.startswith("nerfbench._by_name."):
            del sys.modules[name]


@pytest.mark.parametrize("device,delay_s,least_s", [
    pytest.param("cpu", 0.02, 0.018, id="cpu"),
    pytest.param("cuda", 0.005, 0.0045, id="cuda", marks=pytest.mark.cuda)])
def test_a_planted_host_delay_is_a_gap_put_down_to_its_span(device, delay_s, least_s):
    """Between two operations the host sleeps inside a span: the device's
    gap there is at least the sleep, and both the idle split and the gap's
    name in the breakdown give it to that span."""
    from emernerf_torch.utils.trace import span

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device(device)
    x = torch.ones(1 << 16, device=dev)

    def work():
        with span("unit"):
            y = x * 2.0
            with span("planted"):
                time.sleep(delay_s)
            (y + 1.0).sum()

    work()
    sp = trace.profile_span(work, dev)
    assert sp["idle_by_span"]["planted"] >= least_s
    # all of the span's idle is placed: the named spans' and the rest's
    idle = sum(sp["idle_by_span"].values())
    assert idle == pytest.approx(sp["wall_s"] - sp["busy_s"])
    assert sp["idle_by_span"][spans.UNTRACED] < 0.1 * idle
    assert max(g for g, _ in sp["gaps"]) >= least_s
    name, gap = trace.breakdown(sp)["idle_gaps"][0]
    assert name.startswith("planted after ") and gap >= least_s
    # the gaps and their spans stay aligned with the unwrapped fields
    assert len(sp["gap_spans"]) == len(sp["gaps"])
    assert sp["launches"] == len(sp["intervals_ns"])


def _rec(i, parent, name, a, b, unit=1):
    return Record(i, parent, unit, name, a, b)


def test_idle_split_and_gap_names_on_hand_made_intervals():
    # unit [0, 100] > a [10, 40] > b [20, 30]; then c [50, 90]; ns
    recs = [_rec(3, 2, "b", 20, 30), _rec(2, 1, "a", 10, 40), _rec(4, 1, "c", 50, 90),
            _rec(1, 0, "unit", 0, 100)]
    # device busy over [0, 15], [25, 26], [45, 80]; window [0, 120]
    intervals = [(0, 15, "k0"), (25, 26, "k1"), (45, 80, "k2")]
    idle, gap_spans = spans.split_idle(intervals, recs, 0, 120)
    want = {"a": 5 + 10, "b": 5 + 4, "unit": 5 + 10, "c": 10, spans.UNTRACED: 20}
    assert idle == pytest.approx({k: v * 1e-9 for k, v in want.items()})
    # gaps [15, 25] (a 5, b 5: the first held), [26, 45] (b 4, a 10, unit 5)
    assert gap_spans == ["a", "a"]
    assert spans.idle_intervals(intervals, 0, 120)[-1] == (80, 120, None)
    # the profiled span idled 100 ns: what no named span holds is untraced
    assert spans.by_span(idle, 100e-9) == pytest.approx(
        {"a": 15e-9, "b": 9e-9, "unit": 15e-9, "c": 10e-9, spans.UNTRACED: 51e-9})
    # operations outside the spans' window [10, 100]: their gaps are not
    # placed in it, so they go to untraced, not missing
    idle, _ = spans.split_idle([(0, 5, "k0"), (8, 9, "k1")] + intervals[1:], recs, 10, 100)
    assert sum(idle.values()) == pytest.approx((15 + 19 + 20) * 1e-9)
    assert spans.by_span(idle, 70e-9)[spans.UNTRACED] == pytest.approx(16e-9)
    line = spans.placement([(0, 5, "k0"), (25, 26, "k1"), (45, 130, "k2")], 10, 100, 2e-9, 3e-9)
    assert "3 device operations, the first at its start -0.000 ms, the last ending at its " \
        "end +0.000 ms, 0.000 ms of them inside it" in line
    span = {"gaps": [(10e-9, "k0"), (19e-9, "k1")], "gap_spans": [None, "a"]}
    assert spans.named_gaps(span) == [["a after k1", 19e-9], ["after k0", 10e-9]]
    total, own = spans.host_s_by_name(recs)
    assert total["unit"] == pytest.approx(100e-9) and own["unit"] == pytest.approx(30e-9)
    assert own["a"] == pytest.approx(20e-9)
    # the report's idle is already per unit; its host ms are divided by the units
    line = spans.report({"spans": recs, "wall_s": 4e-3, "idle_by_span": {"a": 3e-3}}, 2)
    assert "profiled span 2.000 ms" in line and "'unit': 0.0" in line
    assert "idle ms a unit by span {'a': 3.0}" in line


def _hand_made(kind):
    """Two units of each span a reader reads (the spans 1 ms and 3 ms), one
    ``render`` outside the step (the refresh's), which no reader counts."""
    recs, i = [], 1
    root = "trainer.iteration" if kind == "train" else "eval.frame"
    for u in range(2):
        unit = i
        recs.append(Record(unit, 0, unit, root, 0, 100_000_000))
        i += 1
        names = ["trainer.sample", "step.backward", "optim.update"] if kind == "train" else \
            list(EVAL.values())
        for n in names:
            recs.append(Record(i, unit, unit, n, 0, 1_000_000 * (1 + 2 * u)))
            i += 1
        if kind == "train":
            recs.append(Record(i, unit, unit, "step.pixel", 0, 50_000_000))
            recs.append(Record(i + 1, i, unit, "render", 0, 1_000_000 * (1 + 2 * u)))
            recs.append(Record(i + 2, unit, unit, "render", 0, 7_000_000))
            i += 3
    return {"kind": kind, "units": 2, "span": {"spans": recs}}


@pytest.mark.parametrize("metric", NEW)
def test_a_reader_reads_its_spans_and_none_without(metric):
    mod = harness.load_module("metrics", f"{metric}.py")
    kind = "train" if metric in TRAIN else "eval"
    other = "eval" if kind == "train" else "train"
    assert mod.read(None) is None
    assert mod.read({"kind": kind, "units": 2, "span": {"busy_s": 1.0}}) is None
    assert mod.read({"kind": kind, "units": 2, "span": {"spans": []}}) is None
    assert mod.read(_hand_made(other)) is None
    assert mod.read(_hand_made(kind)) == pytest.approx(2.0)  # (1 + 3) ms over 2 units


@pytest.mark.parametrize("cell", ["flagship-train", "flagship-eval"])
def test_a_tiny_traced_run_prints_the_span_metrics(monkeypatch, capsys, cell):
    rc, line, err = tiny.run_tiny(monkeypatch, cell, trace=1)
    assert rc == 0, err
    bench = harness.manifest()
    mine = {m["name"] for m in harness.cell_metrics(bench, cell, "per_layer")} & set(NEW)
    assert mine == set(TRAIN if cell == "flagship-train" else EVAL)
    assert all(line["metrics"][m]["value"] > 0 for m in mine)
    assert "nerfbench: spans: " in capsys.readouterr().err
    assert any(" after " in n and not n.startswith("after ")
               for n, _ in line["breakdown"]["idle_gaps"])


def test_the_spans_leave_every_other_reading_as_it_was(monkeypatch):
    """The same tiny traced run with the spans and without: the same
    device operations, by name and by count."""
    plain_profile = trace.profile_span.unwrapped
    got = []
    # loaded now, the readers do not wrap the stand-ins below again
    for metric in NEW:
        harness.load_module("metrics", f"{metric}.py")

    def run(profile_span):
        with monkeypatch.context() as m:
            m.setattr(trace, "profile_span",
                      lambda fn, dev: got.append(profile_span(fn, dev)) or got[-1])
            rc, line, err = tiny.run_tiny(monkeypatch, "flagship-train", trace=1)
        assert rc == 0, err
        return line

    with_spans = run(trace.profile_span)
    without = run(plain_profile)
    assert "spans" in got[0] and "spans" not in got[1]
    assert got[0]["launches"] == got[1]["launches"]
    assert set(got[0]["kernels"]) == set(got[1]["kernels"])
    assert (with_spans["metrics"]["train_launches_per_it"]
            == without["metrics"]["train_launches_per_it"])
    assert "train_sample_host_ms_per_it" not in without["metrics"]
