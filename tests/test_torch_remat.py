"""``optim.remat`` in the port: the field query of each render runs under
``torch.utils.checkpoint`` and is recomputed in the backward.  One
training branch with remat against the same branch without it, from the
same params, batch and draws, on the CPU: the losses and every gradient
are bit for bit, on the pixel and the lidar branch, with top-K sample
pruning and without, on the tiny flagship (fused brick grids) and the
tiny reference-hash profile (separate hash grids).  The field's forward
runs twice per render with remat (the recomputation), once without."""

import dataclasses

import pytest
import torch

from emernerf_torch.data.scene import draw_lidar, draw_pixel, sample_lidar_batch, sample_pixel_batch
from emernerf_torch.flagship import DEFAULT_PROFILE, REFERENCE_HASH, build_flagship
from emernerf_torch.train.step import build_train_step, draw_step

# pruned: 6 of 8 samples shaded (4 on the lidar branch), both proposal
# levels wide enough to carry gradients; unpruned: every sample shaded
PROP = ["nerf.propnet.num_samples_per_prop=[32,16]", "nerf.sampling.num_samples=8"]
PRUNED = PROP + ["nerf.sampling.sample_topk=6", "nerf.sampling.lidar_sample_topk=4"]
UNPRUNED = PROP + ["nerf.sampling.sample_topk=0", "nerf.sampling.lidar_sample_topk=0"]
TABLE_SCALE = 2000.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _branch(step, model, props, batch, draws, lidar):
    """(aux metrics, {name: gradient}) of one branch's loss, and the
    field's forward calls."""
    calls = []
    forward = model.forward

    def counted(*args, **kw):
        calls.append(1)
        return forward(*args, **kw)

    model.forward = counted
    try:
        loss_fn = step.lidar_loss if lidar else step.pixel_loss
        total, aux = loss_fn(batch, draws, 0, True)
        total.backward()
    finally:
        del model.forward
    named = [(f"{i}.{n}", p) for i, m in enumerate([model, *props]) for n, p in m.named_parameters()]
    grads = {n: p.grad for n, p in named}
    for _, p in named:
        p.grad = None
    return aux, grads, len(calls)


@pytest.mark.parametrize("profile", [DEFAULT_PROFILE, REFERENCE_HASH], ids=["brick", "hash"])
@pytest.mark.parametrize("pruning", [PRUNED, UNPRUNED], ids=["topk", "all_samples"])
@pytest.mark.parametrize("lidar", [False, True], ids=["pixel", "lidar"])
def test_remat_step_is_bit_for_bit(profile, pruning, lidar):
    _, dataset, model, props, scfg = build_flagship(tiny=True, overrides=pruning, profile=profile,
                                                    device="cpu", seed=2)
    with torch.no_grad():
        for m in (model, *props):
            for name, p in m.named_parameters():
                if name.endswith("table"):
                    p.mul_(TABLE_SCALE)
    assert not scfg.remat
    plain = build_train_step(model, props, scfg)
    remat = build_train_step(model, props, dataclasses.replace(scfg, remat=True))
    scene = dataset.scene_tensors("cpu")
    gen = torch.Generator().manual_seed(5)
    batch = (sample_lidar_batch(scene, draw_lidar(scene, 128, gen)) if lidar
             else sample_pixel_batch(scene, draw_pixel(scene, 128, gen)))
    draws = draw_step(128, plain.render_kw(lidar), model.has_flow, gen)
    aux, grads, calls = _branch(plain, model, props, batch, draws, lidar)
    raux, rgrads, rcalls = _branch(remat, model, props, batch, draws, lidar)
    assert (calls, rcalls) == (1, 2)  # the recomputation in the backward
    assert set(aux) == set(raux)
    for k in aux:
        assert torch.equal(aux[k], raux[k]), k
    assert any(g is not None and g.abs().sum() > 0 for g in grads.values())
    for name, g in grads.items():
        rg = rgrads[name]
        assert (g is None) == (rg is None), name
        assert g is None or torch.equal(g, rg), name
