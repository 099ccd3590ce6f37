"""How ``correct`` is decided: the plain reference (the frozen float32 copy
in ``plain/``, with TF32 off) follows what the timed path produced, from
the benchmark's weights and the program's recorded feeds, and each number
compared is held to its limit.

Nothing here imports the program.  The scene (images, poses, lidar) is the
input both sides read; every batch row the program fed its steps is first
checked against it, so the sampling that the reference takes as given is
checked by itself.

Training, over the first compared iterations (each a pixel and a lidar
branch, two Adam updates), per leaf the gap between the program's norm and
the reference's over the larger of the reference's norm of that leaf and
of the median leaf:

- ``grad``: of the first iteration's gradients as the optimizer gets them
  (the pixel and the lidar branch's together, read by a hook on each
  parameter before the weight decay is added); the leaf at the 90th
  percentile of the leaves (``GRAD_QUANTILE``), not the worst: the worst
  leaf is the rounding noise of one small leaf (a scalar bias summed over
  half a million samples), as PERF.md sets out;
- ``change``: of the parameters' change over the compared iterations,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by round-off alone); the worst leaf;
- ``grad_diff``: the norm of the difference between the program's and
  the reference's first-iteration gradients (summed over the two
  branches) over the larger of the reference leaf's norm and the median
  leaf's; the leaf at the cell's ``grad_diff_quantile`` (0.9, or 0.8 where
  the few leaves above it swing twofold from seed to seed: the flagship's
  second proposal net, as PERF.md sets out).  A norm gap lets a gradient through that points
  elsewhere with the same length (half of the batch left out: PERF.md); a
  difference does not.

Each iteration's loss is read too (``loss``, the widest relative gap) but
not compared: the control's readings overlap the program's (PERF.md).

Eval, over a seeded sample of each frame's pixels: the widest gap of rgb
and of the static/dynamic decomposition (static and dynamic rgb, dynamic
opacity).  Depth is read (relative, to at least 1 m) but not compared: the
control's readings overlap the program's (PERF.md).
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from nerfbench import harness, weights

LOSS_KEYS = ("total_pixel_loss", "prop_loss", "total_lidar_loss")
GRAD_QUANTILE = 0.9
TRAIN_COMPARED = ("grad", "change", "grad_diff")
EVAL_COMPARED = ("rgb", "decomposition")
EVAL_DECOMP = ("static_rgb", "dynamic_rgb", "dynamic_opacity")


def clone_tree(x):
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(v) for v in x)
    return x


def step_loss(metrics: Dict[str, Any]) -> float:
    return float(sum(float(metrics[k]) for k in LOSS_KEYS if k in metrics))


@torch.no_grad()
def change_norms(leaves, p0) -> List[float]:
    return [float(torch.linalg.vector_norm(p.detach().float() - q)) for (_, p), q in zip(leaves, p0)]


class GradNorms:
    """Inside ``with``: per parameter, the norm over every backward pass of
    the gradients it receives (a hook on each parameter; no kernel of the
    program changes) and, with ``keep``, the sum of those gradients in
    float32 (``sums``), moved to ``keep``'s device on the way out."""

    def __init__(self, params: Sequence[torch.Tensor], keep=None):
        self.params = list(params)
        self.keep = keep
        self.sq: List[Optional[torch.Tensor]] = [None] * len(self.params)
        self.sums: List[Optional[torch.Tensor]] = [None] * len(self.params)

    def __enter__(self):
        def hook(i):
            def fn(g):
                g = g.detach().float()
                s = torch.linalg.vector_norm(g) ** 2
                self.sq[i] = s if self.sq[i] is None else self.sq[i] + s
                if self.keep is not None:
                    self.sums[i] = g.clone() if self.sums[i] is None else self.sums[i] + g
            return fn

        self._handles = [p.register_hook(hook(i)) for i, p in enumerate(self.params)]
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        if self.keep is not None:
            self.sums = [torch.zeros(p.shape, device=self.keep) if g is None
                         else g.to(self.keep) for g, p in zip(self.sums, self.params)]
        return False

    def norms(self) -> List[float]:
        return [0.0 if s is None else float(torch.sqrt(s)) for s in self.sq]


@contextlib.contextmanager
def reference_mode(round_dtype=None):
    """float32 with TF32 off; ``round_dtype``: the control's (forward,
    backward) rounding (``plain/ops/lowp.py``)."""
    from nerfbench.reference.plain.ops import lowp

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lowp.ROUND = round_dtype
    try:
        yield
    finally:
        lowp.ROUND = None
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


# --------------------------------------------------------------------------- #
@torch.no_grad()
def check_feeds(feeds, lidar_idx, scene, batch_size: int) -> List[str]:
    """Every fed batch row is a row of the scene (``scene``: the benchmark's
    scene's tables on the CPU, ``nerfbench/scene.py:facts``), and every
    batch is whole."""
    from nerfbench.reference.plain.data.rays import get_rays

    bad = []
    h, w = scene.images.shape[1:3]
    for i, feed in enumerate(feeds):
        px = {k: v.cpu() for k, v in feed["pixel"].items()}
        n = px["origins"].shape[0]
        if n != batch_size or any(v.shape[0] != n for v in px.values()):
            bad.append(f"iteration {i}: a pixel batch of {n} rows, not {batch_size}")
            continue
        img = px["img_idx"].long()
        y = torch.round(px["pixel_coords"][:, 0] * h).long()
        x = torch.round(px["pixel_coords"][:, 1] * w).long()
        if not bool(torch.isin(img, scene.train_indices).all()):
            bad.append(f"iteration {i}: pixel rows outside the training images")
            continue
        o, d, _ = get_rays(x, y, scene.c2w[img], scene.intrinsics[img])
        if not torch.equal(px["pixels"], scene.images[img, y, x]):
            bad.append(f"iteration {i}: pixel colours that are not the scene's")
        if (o - px["origins"]).abs().max() > 1e-4 or (d - px["viewdirs"]).abs().max() > 1e-5:
            bad.append(f"iteration {i}: pixel rays that are not the scene's")
        if "normed_timestamps" in px and not torch.equal(px["normed_timestamps"],
                                                          scene.normed_timestamps[img]):
            bad.append(f"iteration {i}: pixel timestamps that are not the scene's")
        if "sky_masks" in px and not torch.equal(px["sky_masks"], scene.sky_masks[img, y, x]):
            bad.append(f"iteration {i}: sky masks that are not the scene's")
        if feed["lidar"] is None:
            continue
        lb = {k: v.cpu() for k, v in feed["lidar"].items()}
        idx = lidar_idx[i].cpu()
        if idx.shape[0] != batch_size:
            bad.append(f"iteration {i}: a lidar batch of {idx.shape[0]} rows")
            continue
        for key, table in (("origins", scene.lidar_origins), ("viewdirs", scene.lidar_viewdirs),
                           ("ranges", scene.lidar_ranges),
                           ("normed_timestamps", scene.lidar_normed_timestamps)):
            if not torch.equal(lb[key], table[idx]):
                bad.append(f"iteration {i}: lidar {key} that are not the scene's")
    return bad


# --------------------------------------------------------------------------- #
def plain_config(config: Dict[str, Any], workload: Dict[str, Any]):
    """The reference's configuration: the cell's, computed in float32."""
    from nerfbench.reference.plain.config import ConfigNode

    cfg = ConfigNode(config["cfg"])
    for key, value in workload.get("overrides", {}).items():
        cfg.set_dotted(key, value)
    cfg.set_dotted("nerf.model.table_dtype", "float32")
    cfg.set_dotted("nerf.model.mlp_dtype", "float32")
    return cfg


def build_plain(config, workload, facts, names, seed: int, device):
    """The reference's model and proposal nets with the seed's weights."""
    from nerfbench.reference.plain import builders

    cfg = plain_config(config, workload)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    model = builders.build_model_from_cfg(cfg, facts, device=device, generator=gen)
    props = builders.build_propnets_from_cfg(cfg, facts, device=device, generator=gen)
    leaves = weights.named_leaves(model, props)
    if [n for n, _ in leaves] != list(names):
        raise RuntimeError("the reference's parameters differ from the program's")
    weights.load_weights(leaves, config["init"], seed)
    return cfg, model, props, leaves


def follow_train(config, workload, facts, names, seed: int, device, feeds,
                 round_dtype=None) -> Dict[str, Any]:
    """The reference through the recorded feeds: each iteration's loss, the
    first iteration's gradient norms and summed gradients, the change's
    norms after all."""
    from nerfbench.reference.plain import builders
    from nerfbench.reference.plain.train.state import init_train_state
    from nerfbench.reference.plain.train.step import StepDraws, build_train_step

    with reference_mode(round_dtype):
        cfg, model, props, leaves = build_plain(config, workload, facts, names, seed, device)
        step_fn = build_train_step(model, props, builders.build_train_step_config(cfg, facts))
        state = init_train_state(model, props)
        losses, grads, sums = [], None, None
        for i, f in enumerate(feeds):
            state.step = f["step"]
            ld = None if f["lidar_draws"] is None else StepDraws(*f["lidar_draws"])
            with GradNorms([p for _, p in leaves], keep=device if i == 0 else None) as rec:
                metrics = step_fn(state, f["pixel"], f["lidar"], StepDraws(*f["pixel_draws"]),
                                  ld, f["pixel_rg"], f["lidar_rg"], f["lidar_full"])
            losses.append(step_loss(metrics))
            if i == 0:
                grads, sums = rec.norms(), rec.sums
        p0 = weights.make_weights([(n, tuple(p.shape)) for n, p in leaves], config["init"],
                                  seed, device)
        change = change_norms(leaves, p0)
    return {"losses": losses, "grad": grads, "grad_sum": sums, "change": change}


def leaf_gaps(prog: Sequence[float], ref: Sequence[float],
              keep: Optional[Sequence[bool]] = None) -> np.ndarray:
    """Per kept leaf |prog - ref| over max(ref leaf, median ref leaf)."""
    keep = keep or [True] * len(ref)
    med = statistics.median([r for r, k in zip(ref, keep) if k])
    if not med > 0:
        return np.array([float("inf")])
    return np.array([abs(p - r) / max(r, med) for p, r, k in zip(prog, ref, keep) if k])


@torch.no_grad()
def diff_gaps(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]) -> np.ndarray:
    """Per leaf the norm of the difference of two summed gradients over
    max(the reference leaf's norm, the median leaf's)."""
    dev = ref[0].device
    norms = [float(torch.linalg.vector_norm(r)) for r in ref]
    med = statistics.median(norms)
    if not med > 0:
        return np.array([float("inf")])
    return np.array([float(torch.linalg.vector_norm(p.to(dev) - r)) / max(n, med)
                     for p, r, n in zip(prog, ref, norms)])


def train_numbers(prog, ref, diff_quantile: float) -> Dict[str, float]:
    """Every reading of the program's (or a stand-in's) ``prog`` against the
    reference's ``ref`` (follow_train's keys), ``grad_diff`` at the leaf of
    ``diff_quantile``: the compared ones (TRAIN_COMPARED) and the others."""
    med = statistics.median(ref["grad"])
    keep = [r >= 1e-3 * med for r in ref["grad"]]
    g = leaf_gaps(prog["grad"], ref["grad"])
    d = diff_gaps(prog["grad_sum"], ref["grad_sum"])
    return {"grad": float(np.quantile(g, GRAD_QUANTILE)),
            "change": float(leaf_gaps(prog["change"], ref["change"], keep).max()),
            "grad_diff": float(np.quantile(d, diff_quantile)),
            "grad_diff_median": float(np.median(d)),
            "grad_diff_worst": float(d.max()),
            "grad_worst": float(g.max()),
            "loss": float(max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                                  ref["losses"])))}


def train_checks(nums: Dict[str, float], limits) -> List[harness.Check]:
    return [harness.Check(k, nums[k], float(limits[k])) for k in TRAIN_COMPARED]


# --------------------------------------------------------------------------- #
def eval_rays(facts, img: int, pix: np.ndarray, device) -> Dict[str, torch.Tensor]:
    """The eval rays of pixels ``pix`` (flat indices) of image ``img``."""
    from nerfbench.reference.plain.data.rays import get_rays

    h, w = facts.image_hw
    y = torch.as_tensor(pix // w, device=device)
    x = torch.as_tensor(pix % w, device=device)
    n = len(pix)
    c2w = torch.as_tensor(facts.c2w[img], device=device).expand(n, 4, 4)
    k = torch.as_tensor(facts.intrinsics[img], device=device).expand(n, 3, 3)
    o, d, _ = get_rays(x, y, c2w, k)
    return {"origins": o.contiguous(), "viewdirs": d.contiguous(),
            "pixel_coords": torch.stack([y / h, x / w], -1).float(),
            "normed_timestamps": torch.full((n,), float(facts.normed_timestamps[img]),
                                            device=device),
            "img_idx": torch.full((n,), img, dtype=torch.int32, device=device),
            "cam_idx": torch.full((n,), int(facts.cam_ids[img]), dtype=torch.int32,
                                  device=device)}


@torch.no_grad()
def follow_eval(config, workload, facts, names, seed: int, device, samples,
                round_dtype=None) -> List[Dict[str, np.ndarray]]:
    """The reference's render of every sampled pixel (the samples' image
    and flat pixel indices), as the eval renders it."""
    from nerfbench.reference.plain.render.renderer import render_ray_batch

    with reference_mode(round_dtype):
        cfg, model, props, _ = build_plain(config, workload, facts, names, seed, device)
        kw = dict(num_samples=cfg.nerf.sampling.num_samples,
                  prop_samples=tuple(cfg.nerf.propnet.num_samples_per_prop),
                  near_plane=cfg.nerf.propnet.near_plane, far_plane=cfg.nerf.propnet.far_plane,
                  sampling_type=cfg.nerf.propnet.sampling_type,
                  return_decomposition=model.has_dynamic,
                  sample_topk=int(cfg.get_dotted("render.eval_sample_topk", 0)))
        outs = []
        for s in samples:
            rays = eval_rays(facts, s["img"], s["pix"], device)
            out = render_ray_batch(model, props, rays, train=False, **kw).out
            outs.append({k: out[k].float().cpu().numpy() for k in s["maps"]})
    return outs


def eval_numbers(samples, ref) -> Dict[str, float]:
    rgb = depth = decomp = 0.0
    for s, r in zip(samples, ref):
        rgb = max(rgb, float(np.abs(s["maps"]["rgb"] - r["rgb"]).max()))
        d_p, d_r = s["maps"]["depth"].reshape(-1), r["depth"].reshape(-1)
        depth = max(depth, float((np.abs(d_p - d_r) / np.maximum(np.abs(d_r), 1.0)).max()))
        for k in EVAL_DECOMP:
            if k in s["maps"]:
                a, b = s["maps"][k], r[k].reshape(s["maps"][k].shape)
                decomp = max(decomp, float(np.abs(a - b).max()))
    return {"rgb": rgb, "depth": depth, "decomposition": decomp}


def eval_checks(samples, ref, limits) -> List[harness.Check]:
    nums = eval_numbers(samples, ref)
    return [harness.Check(k, nums[k], float(limits[k])) for k in EVAL_COMPARED]
