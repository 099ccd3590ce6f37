"""PSNR and SSIM of the eval render on the card (``ops/image_metrics.py``,
``kernels/csrc/image_metrics.cu``).

On the CPU: the plain float64 version against ``eval/metrics.py``'s
``compute_psnr`` and ``compute_ssim(full=True)`` (PSNRs within 1e-9 dB,
SSIM means within 1e-8), and ``render_split``'s numpy route unchanged.  On
the card (``cuda`` marker, skipped without one): the kernel against both,
bit for bit between runs, and ``render_split`` routed through it.  This
file imports no JAX; on a machine with an H100 run its card tests with
``python -m pytest tests/test_torch_image_metrics.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from emernerf_torch import kernels
from emernerf_torch.eval import metrics
from emernerf_torch.eval import renderer as eval_renderer
from emernerf_torch.eval.renderer import ImageRenderer
from emernerf_torch.flagship import build_flagship, flagship_config, flagship_flow_spec
from emernerf_torch.ops import image_metrics as im
from emernerf_torch.train.trainer import Trainer

PSNR_TOL = 1e-9  # dB
SSIM_TOL = 1e-8


def _images(h, w, c, seed, mask="random"):
    """A smooth seeded ground truth in [0, 1], a render of it with noise
    that leaves [0, 1] (the clipping shows), and a dynamic mask."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    phase = rng.uniform(0, 2 * np.pi, c)
    base = 0.5 + 0.4 * np.sin(xx[..., None] / 7.0 + phase) * np.cos(yy[..., None] / 5.0)
    gt = np.clip(base + 0.05 * rng.standard_normal((h, w, c)), 0, 1).astype(np.float32)
    pred = (base + 0.15 * rng.standard_normal((h, w, c))).astype(np.float32)
    m = {"random": rng.random((h, w)) < 0.3, "empty": np.zeros((h, w), bool),
         "full": np.ones((h, w), bool), "none": None}[mask]
    return pred, gt, m


def _numpy_metrics(pred, gt, mask, ssim=True):
    """``render_split``'s numbers of one frame by ``eval/metrics.py``."""
    out = {"psnr": metrics.compute_psnr(pred, gt)}
    if ssim:
        out["ssim"], smap = metrics.compute_ssim(np.clip(pred, 0, 1), np.clip(gt, 0, 1),
                                                 full=True)
    if mask is not None and mask.any():
        out["masked_psnr"] = metrics.compute_psnr(pred[mask], gt[mask])
        if ssim:
            out["masked_ssim"] = float(smap[mask].mean())
    if mask is not None and (~mask).any():
        out["non_masked_psnr"] = metrics.compute_psnr(pred[~mask], gt[~mask])
    return out


def _assert_close(ours, ref):
    assert set(ours) == set(ref), (sorted(ours), sorted(ref))
    for k, v in ref.items():
        tol = SSIM_TOL if "ssim" in k else PSNR_TOL
        assert abs(ours[k] - v) <= tol, (k, ours[k], v)


def _metrics(sums_fn, pred, gt, mask, ssim=True, device="cpu"):
    h, w, c = pred.shape
    win = im.ssim_window(h, w) if ssim else None
    t = torch.from_numpy(pred).to(device), torch.from_numpy(gt).to(device)
    m = None if mask is None else torch.from_numpy(mask).to(device)
    sums = sums_fn(*t, m, win)
    return im.frame_metrics(sums.cpu().tolist(), (h, w, c), win, masked=mask is not None), sums


CASES = {
    "rgb": (48, 72, 3, "none", True),
    "rgb_mask": (48, 72, 3, "random", True),
    "rgb_empty_mask": (48, 72, 3, "empty", True),
    "rgb_full_mask": (48, 72, 3, "full", True),
    "shrunk_window_5x6": (5, 6, 3, "random", True),
    "shrunk_window_4x9": (4, 9, 3, "random", True),
    "shrunk_window_6x4": (6, 4, 3, "random", True),
    "shrunk_window_2x3": (2, 3, 3, "full", True),
    "shrunk_window_1x5": (1, 5, 3, "random", True),
    "features": (24, 40, 64, "random", False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_numpy_metrics(case):
    h, w, c, mask, ssim = CASES[case]
    pred, gt, m = _images(h, w, c, seed=sorted(CASES).index(case), mask=mask)
    ours, sums = _metrics(im.image_metric_sums_plain, pred, gt, m, ssim)
    assert sums.dtype == torch.float64 and sums.shape == (len(im.SUMS),)
    _assert_close(ours, _numpy_metrics(pred, gt, m, ssim))


def _with_nan(mask):
    """The rgb case with one NaN in the render, as a diverged model gives."""
    pred, gt, m = _images(48, 72, 3, seed=5, mask=mask)
    pred[20, 30, 1] = np.nan
    return pred, gt, m


def _assert_same_nans(ours, ref):
    """NaN in the same numbers, the rest within the tolerances."""
    assert set(ours) == set(ref), (sorted(ours), sorted(ref))
    nan = {k for k, v in ref.items() if np.isnan(v)}
    assert {k for k, v in ours.items() if np.isnan(v)} == nan
    _assert_close({k: v for k, v in ours.items() if k not in nan},
                  {k: v for k, v in ref.items() if k not in nan})


def test_plain_version_keeps_a_nan_of_the_render():
    """np.clip keeps NaN in compute_ssim: with every pixel under the mask,
    every number is NaN on both routes."""
    pred, gt, m = _with_nan("full")
    ours, _ = _metrics(im.image_metric_sums_plain, pred, gt, m)
    ref = _numpy_metrics(pred, gt, m)
    assert all(np.isnan(v) for v in ref.values())
    _assert_same_nans(ours, ref)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_checks_its_inputs():
    pred, gt, m = _images(8, 10, 3, seed=3)
    p, g, mt = torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(m)
    before = im.image_metric_sums.launches
    assert torch.equal(im.image_metric_sums(p, g, mt, 7), im.image_metric_sums_plain(p, g, mt, 7))
    assert im.image_metric_sums.launches == before
    with pytest.raises(ValueError, match="float32"):
        im.image_metric_sums(p.double(), g, mt, 7)
    with pytest.raises(ValueError, match="one shape"):
        im.image_metric_sums(p, g[:, :-1], mt, 7)
    with pytest.raises(ValueError, match="mask"):
        im.image_metric_sums(p, g, mt.float(), 7)
    for win in (6, 9, 0):
        with pytest.raises(ValueError, match="window"):
            im.image_metric_sums(p, g, mt, win)


@pytest.fixture(scope="module")
def tiny_trainer():
    cfg = flagship_config(tiny=True)
    torch.manual_seed(0)
    return Trainer(cfg, device="cpu", flow=flagship_flow_spec(cfg, tiny=True))


def _old_render_split_metrics(frames):
    """The numbers ``render_split`` returned before it could compute them on
    the card, from its frames, as it computed them then."""
    psnrs, ssims, dyn_psnrs, stat_psnrs, dyn_ssims = [], [], [], [], []
    for maps in frames:
        rgb, pixels = maps["rgb"], maps["gt_rgb"]
        psnrs.append(metrics.compute_psnr(rgb, pixels))
        ssim_mean, ssim_map = metrics.compute_ssim(np.clip(rgb, 0, 1), np.clip(pixels, 0, 1),
                                                   full=True)
        ssims.append(ssim_mean)
        m = maps["gt_dynamic_mask"] > 0.5
        if m.sum() > 0:
            dyn_psnrs.append(metrics.compute_psnr(rgb[m], pixels[m]))
            dyn_ssims.append(float(ssim_map[m].mean()))
        if (~m).sum() > 0:
            stat_psnrs.append(metrics.compute_psnr(rgb[~m], pixels[~m]))
    out = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
    if dyn_psnrs:
        out["masked_psnr"] = float(np.mean(dyn_psnrs))
        out["masked_ssim"] = float(np.mean(dyn_ssims))
    if stat_psnrs:
        out["non_masked_psnr"] = float(np.mean(stat_psnrs))
    return out


def test_render_split_on_the_cpu_returns_what_it_returned(tiny_trainer):
    """On the CPU the numpy route of before: the same dict, in the same
    order, and no kernel; one frame without a masked pixel, one with."""
    before = im.image_metric_sums.launches
    frames, out = tiny_trainer.renderer.render_split(tiny_trainer.dataset, [0, 1])
    assert im.image_metric_sums.launches == before
    assert [f["gt_dynamic_mask"].any() for f in frames] == [False, True]
    ref = _old_render_split_metrics(frames)
    assert out == ref and list(out) == list(ref)
    assert "rgb" in frames[0] and frames[0]["rgb"].dtype == np.float32
    _, none = tiny_trainer.renderer.render_split(tiny_trainer.dataset, [0],
                                                 compute_metrics=False)
    assert none == {}


# ---------------------------------------------------------------- card only


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


CARD_CASES = {
    "frame_640x960": (640, 960, 3, "random", True),
    "frame_640x960_no_mask": (640, 960, 3, "none", True),
    "shrunk_window": (5, 6, 3, "random", True),
    "features": (160, 240, 64, "random", False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_plain_and_numpy(cuda, case):
    h, w, c, mask, ssim = CARD_CASES[case]
    pred, gt, m = _images(h, w, c, seed=7 + len(case), mask=mask)
    before = im.image_metric_sums.launches
    ours, sums = _metrics(im.image_metric_sums, pred, gt, m, ssim, device=cuda)
    torch.cuda.synchronize()
    assert im.image_metric_sums.launches == before + 1 and sums.device.type == "cuda"
    _assert_close(ours, _numpy_metrics(pred, gt, m, ssim))
    plain, plain_sums = _metrics(im.image_metric_sums_plain, pred, gt, m, ssim)
    _assert_close(ours, plain)
    # the mask's count is exact; the sums agree to float64 rounding
    assert sums[3].item() == plain_sums[3].item()
    torch.testing.assert_close(sums.cpu(), plain_sums, rtol=1e-12, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["full", "random"])
def test_kernel_keeps_a_nan_of_the_render(cuda, mask):
    """A NaN in the render: NaN in the same sums as the plain version (the
    squared errors that hold it, the SSIM of every window over it), the
    others as close as ever; with the mask over every pixel, NaN in every
    number, as on the numpy route."""
    pred, gt, m = _with_nan(mask)
    ours, sums = _metrics(im.image_metric_sums, pred, gt, m, device=cuda)
    plain, plain_sums = _metrics(im.image_metric_sums_plain, pred, gt, m)
    sums = sums.cpu()
    assert torch.equal(sums.isnan(), plain_sums.isnan()) and sums.isnan().any()
    finite = ~plain_sums.isnan()
    torch.testing.assert_close(sums[finite], plain_sums[finite], rtol=1e-12, atol=1e-9)
    _assert_same_nans(ours, plain)
    if mask == "full":
        _assert_same_nans(ours, _numpy_metrics(pred, gt, m))


@pytest.mark.cuda
def test_kernel_is_bit_for_bit_between_runs(cuda):
    pred, gt, m = _images(640, 960, 3, seed=11)
    t = [torch.from_numpy(a).to(cuda) for a in (pred, gt, m)]
    runs = [im.image_metric_sums(*t, 7).cpu() for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    feats = [im.image_metric_sums(t[0].repeat(1, 1, 3), t[1].repeat(1, 1, 3), t[2]).cpu()
             for _ in range(2)]
    assert torch.equal(feats[0], feats[1])


@pytest.mark.cuda
def test_render_split_computes_its_metrics_on_the_card(cuda, monkeypatch):
    """One kernel launch a frame for rgb, no numpy SSIM, the fetched maps as
    on the CPU route, and its numbers within the tolerances of the numpy
    route on the same maps."""
    kernels.load()
    cfg = flagship_config(tiny=True)
    torch.manual_seed(0)
    tr = Trainer(cfg, device=cuda, flow=flagship_flow_spec(cfg, tiny=True))
    calls = []
    real = metrics.compute_ssim
    monkeypatch.setattr(metrics, "compute_ssim", lambda *a, **k: calls.append(1) or real(*a, **k))
    before = im.image_metric_sums.launches
    frames, out = tr.renderer.render_split(tr.dataset, [0, 1, 2])
    assert im.image_metric_sums.launches == before + 3 and not calls
    assert all(isinstance(f["rgb"], np.ndarray) and f["rgb"].dtype == np.float32
               for f in frames)
    per_frame = [eval_renderer._host_metrics(
        f, {"pixels": f["gt_rgb"], "dynamic_masks": f["gt_dynamic_mask"]}) for f in frames]
    ref = {k: float(np.mean([p[k] for p in per_frame if k in p]))
           for k in eval_renderer._METRIC_KEYS if any(k in p for p in per_frame)}
    _assert_close(out, ref)
    assert list(out) == list(ref)


def _feature_split(root, device):
    """``render_split`` of two frames of the tiny flagship with the feature
    head on a Waymo-layout scene with 16-channel feature maps; returns the
    frames, the metrics and the numpy route's numbers on the same maps."""
    overrides = [f"data.data_root={root}", "data.dataset=waymo", "data.scene_idx=0",
                 "data.pixel_source.num_cams=3", "data.pixel_source.load_size=[16,24]",
                 "data.pixel_source.load_features=true",
                 "data.pixel_source.skip_feature_extraction=true",
                 "data.pixel_source.target_feature_dim=16",
                 "nerf.model.head.enable_feature_head=true",
                 "nerf.model.neck.semantic_feature_dim=8",
                 "nerf.model.head.feature_mlp_layer_width=16"]
    cfg, dataset, model, props, _ = build_flagship(tiny=True, overrides=overrides, device=device)
    ren = ImageRenderer(model, props, num_samples=cfg.nerf.sampling.num_samples,
                        prop_samples=tuple(cfg.nerf.propnet.num_samples_per_prop),
                        near_plane=cfg.nerf.propnet.near_plane,
                        far_plane=cfg.nerf.propnet.far_plane,
                        sampling_type=cfg.nerf.propnet.sampling_type, chunk_size=192,
                        return_decomposition=True, device=device)
    frames, out = ren.render_split(dataset, [0, 4])
    per_frame = [eval_renderer._host_metrics(f, dataset.get_image_rays(i)[1])
                 for f, i in zip(frames, [0, 4])]
    ref = {k: float(np.mean([p[k] for p in per_frame if k in p]))
           for k in eval_renderer._METRIC_KEYS if any(k in p for p in per_frame)}
    return frames, out, ref


@pytest.mark.cuda
def test_render_split_feature_psnr_on_the_card(cuda, tmp_path):
    """With the feature head, one more launch a frame (the features, no
    SSIM) and ``feat_psnr``, ``masked_feat_psnr`` within the tolerances of
    the numpy route on the same maps."""
    kernels.load()
    chip_smoke.write_waymo_scene(str(tmp_path), n_frames=4, num_cams=3, n_lidar=500,
                                 feat_shape=(6, 8, 24), image_hw=(64, 96), occ_voxels=50)
    before = im.image_metric_sums.launches
    frames, out, ref = _feature_split(tmp_path, cuda)
    assert im.image_metric_sums.launches == before + 4
    assert {"feat_psnr", "masked_feat_psnr"} <= set(out)
    _assert_close(out, ref)
