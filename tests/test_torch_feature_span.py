"""The feature head's span (``field.feature`` in ``models/fields.py``) on the
CPU at the tiny size: one traced training render with the head records it
under ``render.field``, once in the field query and once in the sky query;
the same render without the head records none."""

import pytest
import torch

from emernerf_torch.flagship import build_flagship
from emernerf_torch.render.renderer import render_ray_batch
from emernerf_torch.utils import trace

HEAD = ("nerf.model.head.enable_feature_head=true",)
N_RAYS = 8


@pytest.fixture(autouse=True)
def _one_thread_tracing_off():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    trace.disable()
    torch.set_num_threads(threads)


def _traced_render(overrides):
    cfg, _, model, props, _ = build_flagship(tiny=True, overrides=overrides, device="cpu")
    gen = torch.Generator().manual_seed(0)
    dirs = torch.nn.functional.normalize(torch.randn(N_RAYS, 3, generator=gen), dim=-1)
    rays = {"origins": torch.zeros(N_RAYS, 3), "viewdirs": dirs,
            "normed_timestamps": torch.full((N_RAYS,), 0.5),
            "img_idx": torch.zeros(N_RAYS, dtype=torch.int32),
            "pixel_coords": torch.rand(N_RAYS, 2, generator=gen)}
    trace.enable()
    out = render_ray_batch(model, props, rays, num_samples=cfg.nerf.sampling.num_samples,
                           prop_samples=tuple(cfg.nerf.propnet.num_samples_per_prop),
                           requires_grad=True, train=True)
    records = trace.disable()
    return out.out, records


def test_the_feature_span_opens_under_the_field_query_and_the_sky_query():
    out, records = _traced_render(HEAD)
    assert "dino_feat" in out
    by_id = {r.id: r for r in records}
    feature = [r for r in records if r.name == "field.feature"]
    assert len(feature) == 2
    assert all(by_id[r.parent].name == "render.field" for r in feature)
    # the field query's (PE map, DINO head on both branches) closes before the
    # sky query's (the sky feature head), which the field query runs last
    first, second = sorted(feature, key=lambda r: r.start_ns)
    assert first.end_ns <= second.start_ns
    assert all(r.start_ns <= r.end_ns for r in feature)


def test_no_feature_span_without_the_head():
    out, records = _traced_render(())
    assert "dino_feat" not in out
    names = {r.name for r in records}
    assert "render.field" in names and "field.feature" not in names
