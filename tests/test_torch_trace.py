"""The port's span tracer (``emernerf_torch/utils/trace.py``) on the CPU:
off it records nothing and enters no ``record_function``; on, the records'
nesting, units and clock; the spans that one iteration of the tiny
flagship and one eval frame open, layer by layer; and the Trainer's
profiler window, which records the spans only where no caller does."""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from emernerf_torch.flagship import flagship_config, flagship_flow_spec
from emernerf_torch.train.trainer import Trainer
from emernerf_torch.utils import trace


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    trace.disable()


def _profiled_names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def _spans():
    with trace.span("outer"):
        with trace.span("inner"):
            torch.ones(3).sum()


def test_off_records_nothing_and_enters_no_record_function():
    assert trace.span("a") is trace.span("b") and not trace.enabled()
    names = _profiled_names(_spans)
    assert "aten::sum" in names and not {"outer", "inner"} & names
    assert trace.disable() == []


@pytest.mark.parametrize("annotate", [False, True])
def test_annotate_alone_puts_spans_in_the_profiler(annotate):
    trace.enable(annotate=annotate)
    names = _profiled_names(_spans)
    assert ({"outer", "inner"} <= names) == annotate
    assert [r.name for r in trace.disable()] == ["inner", "outer"]


def test_nesting_units_and_clock():
    before = time.time_ns()
    trace.enable()
    assert trace.enabled()
    with pytest.raises(RuntimeError, match="on already"):
        trace.enable()
    for _ in range(2):
        _spans()
    with trace.span("alone"):
        pass
    recs = {(r.unit, r.name): r for r in trace.disable()}
    after = time.time_ns()
    assert trace.disable() == []
    units = sorted({u for u, _ in recs})
    assert len(units) == 3
    for u in units[:2]:
        outer, inner = recs[(u, "outer")], recs[(u, "inner")]
        assert outer.id == u and outer.parent == 0 and inner.parent == outer.id
        assert before <= outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns <= after
    alone = recs[(units[2], "alone")]
    assert alone.parent == 0 and alone.id == units[2]
    with trace.span("late"):  # off again: nothing kept
        pass
    assert trace.disable() == []


def test_a_span_closed_after_disable_is_not_kept():
    trace.enable()
    with trace.span("kept"):
        pass
    with trace.span("open"):
        recs = trace.disable()
    assert [r.name for r in recs] == ["kept"]


def _tree(records):
    kids = {}
    for r in records:
        kids.setdefault(r.parent, []).append(r)
    for v in kids.values():
        v.sort(key=lambda r: r.start_ns)
    return kids


def _names(kids, rec):
    return [r.name for r in kids.get(rec.id, [])]


@pytest.fixture(scope="module")
def trainers():
    """The tiny flagship, its branches apart and fused, past two
    iterations; every step logs and every second one refreshes."""
    out = {}
    for name, extra in (("branches", []), ("fused", ["optim.fused_lidar_branch=true"])):
        cfg = flagship_config(tiny=True, overrides=["logging.print_freq=1",
                                                    "optim.cache_rgb_freq=2"] + extra)
        torch.manual_seed(0)
        tr = Trainer(cfg, device="cpu", flow=flagship_flow_spec(cfg, tiny=True))
        for step in range(2):
            tr.train_iteration(step)
        out[name] = tr
    return out


@pytest.mark.parametrize("kind", ["branches", "fused"])
def test_one_iteration_opens_the_span_tree(trainers, kind):
    tr = trainers[kind]
    trace.enable()
    tr.train_iteration(2)
    recs = trace.disable()
    kids = _tree(recs)
    (root,) = kids[0]
    assert root.name == "trainer.iteration"
    assert all(r.unit == root.id for r in recs)
    branches = ["step.joint"] if kind == "fused" else ["step.pixel", "step.lidar"]
    assert _names(kids, root) == (["trainer.sample"] + branches
                                  + ["trainer.log", "trainer.refresh"])
    for branch in kids[root.id][1:-2]:
        assert _names(kids, branch) == ["render", "step.loss", "step.backward", "optim.update"]
        render = kids[branch.id][0]
        assert _names(kids, render) == ["render.sampler", "render.field", "render.composite"]
    # the refresh renders through the eval renderer: its spans nest there
    refresh = kids[root.id][-1]
    assert {"eval.rays", "eval.chunk"} <= set(_names(kids, refresh))
    # the children account for the iteration's host time
    covered = sum(r.end_ns - r.start_ns for r in kids[root.id])
    assert covered >= 0.9 * (root.end_ns - root.start_ns)


def test_one_eval_frame_opens_the_eval_spans(trainers):
    tr = trainers["branches"]
    ren = tr.renderer
    trace.enable()
    frames, _ = ren.render_split(tr.dataset, [0])
    recs = trace.disable()
    kids = _tree(recs)
    (root,) = kids[0]
    assert root.name == "eval.frame"
    h, w = frames[0]["rgb"].shape[:2]
    n_chunks = -(-h * w // ren.chunk_size)
    names = _names(kids, root)
    assert names == ["eval.rays", "eval.rays"] + ["eval.chunk"] * n_chunks + ["eval.metrics"]
    # each chunk uploads, renders and fetches its outputs: one wait a chunk
    for c in (r for r in kids[root.id] if r.name == "eval.chunk"):
        assert _names(kids, c) == ["eval.upload", "render", "eval.fetch"]


@pytest.mark.parametrize("caller_traces", [False, True])
def test_the_profiler_window_records_spans_only_where_no_caller_does(tmp_path, caller_traces):
    """The window annotates its chrome trace with the spans where tracing
    was off, and turns it off again; a caller's tracing stays on through
    the window, with every iteration's records, and the window's trace
    then carries none."""
    cfg = flagship_config(tiny=True, overrides=["optim.num_iters=3",
                                                "logging.profiling_start_iter=1",
                                                "logging.profiling_num_iters=1"])
    torch.manual_seed(0)
    tr = Trainer(cfg, log_dir=str(tmp_path), device="cpu",
                 flow=flagship_flow_spec(cfg, tiny=True))
    if caller_traces:
        trace.enable()
    tr.train()
    assert trace.enabled() == caller_traces
    iterations = [r for r in trace.disable() if r.name == "trainer.iteration"]
    assert len(iterations) == (4 if caller_traces else 0)
    chrome = json.loads((tmp_path / "profile" / "trace_00002.json").read_text())
    names = [e.get("name") for e in chrome["traceEvents"]]
    assert names.count("trainer.iteration") == (0 if caller_traces else 2)
