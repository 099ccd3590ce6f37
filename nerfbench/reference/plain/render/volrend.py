"""Volume rendering / alpha compositing (port of ``emernerf_tpu/render/volrend.py``),
the port's plain path of its K3 kernels.

``composite_along_rays`` computes, for up to three density sets (total,
static, dynamic), transmittance, weights, opacity and depth, the median
depth of the first set, and the weighted sums of a packed (R, S, C) value
tensor whose channel c is weighted by set ``chan_set[c]``; autograd takes
the gradients to the densities and the values (the sample edges are
detached).  ``composite_rays`` is the dict glue around it and keeps the
reference's keys and formulas.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from nerfbench.reference.plain.ops.clip import clip
from nerfbench.reference.plain.ops.stepfuns import exclusive_cumsum


class Composited(NamedTuple):
    weights: torch.Tensor  # (R, S, D)
    trans: torch.Tensor  # (R, S, D)
    opacity: torch.Tensor  # (R, D), clipped to [1e-6, 1]
    depth: torch.Tensor  # (R, D)
    median_depth: torch.Tensor  # (R, 1), of density set 0
    sums: torch.Tensor  # (R, C)


def composite_along_rays(t_starts: torch.Tensor, t_ends: torch.Tensor,
                         densities: torch.Tensor,
                         values: Optional[torch.Tensor] = None,
                         chan_set: Sequence[int] = ()) -> Composited:
    """Transmittance, weights and per-ray reductions for D density sets.

    t_starts/t_ends (R, S); densities (R, S, D); values (R, S, C) or None;
    chan_set: C ints, the density set that weights each value channel."""
    r, s = t_starts.shape
    sdt = densities * (t_ends - t_starts)[..., None]
    trans = torch.exp(-exclusive_cumsum(sdt, dim=1))
    weights = trans * (1.0 - torch.exp(-sdt))
    opacity = clip(weights.sum(dim=1), 1e-6, 1.0)
    steps = (t_starts + t_ends) / 2.0
    depth = (weights * steps[..., None]).sum(dim=1) / opacity
    cum = torch.cumsum(weights[..., 0], dim=-1)
    median_index = (cum < 0.5).sum(dim=-1, keepdim=True).clamp(0, s - 1)
    median_depth = torch.gather(steps, -1, median_index)
    if values is None:
        sums = weights.new_zeros((r, 0))
    else:
        sums = (weights[..., list(chan_set)] * values).sum(dim=1)
    return Composited(weights, trans, opacity, depth, median_depth, sums)


class _Packer:
    """Collects (R, S, c) value blocks with their density set into one packed
    (R, S, C) tensor, and splits the (R, C) sums back by name."""

    def __init__(self):
        self.blocks, self.sets, self.names = [], [], []

    def add(self, name: str, values: torch.Tensor, dset: int) -> None:
        self.names.append((name, values.shape[-1]))
        self.blocks.append(values)
        self.sets += [dset] * values.shape[-1]

    def values(self):
        return torch.cat(self.blocks, dim=-1).contiguous() if self.blocks else None

    def split(self, sums: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, i = {}, 0
        for name, width in self.names:
            out[name] = sums[:, i:i + width]
            i += width
        return out


_EXTRA_KEYS = ("forward_flow", "backward_flow", "forward_pred_backward_flow",
               "backward_pred_forward_flow", "agg_mask")


def composite_rays(t_starts: torch.Tensor, t_ends: torch.Tensor,
                   results: Dict[str, torch.Tensor],
                   return_decomposition: bool = False) -> Dict[str, torch.Tensor]:
    """Composite per-sample field outputs along rays.  ``results`` is the
    field-query dict; returns per-ray quantities plus an ``extras`` dict."""
    t_starts, t_ends = t_starts.contiguous(), t_ends.contiguous()
    density = results["density"]
    has_decomp = "static_density" in results and "dynamic_density" in results
    decomp = has_decomp and return_decomposition
    sets = [density]
    if decomp:
        sets += [results["static_density"], results["dynamic_density"]]
    densities = torch.stack(sets, dim=-1)
    total, static, dynamic = 0, 1, 2

    # ---------- value channels, each under its weight set ----------
    pack = _Packer()
    if has_decomp:
        static_ratio = results["static_density"] / (density + 1e-6)
        dynamic_ratio = results["dynamic_density"] / (density + 1e-6)
    if "rgb" in results:
        pack.add("rgb", results["rgb"], total)
    elif "static_rgb" in results and "dynamic_rgb" in results:
        shadow_ratio = 0.0
        if "shadow_ratio" in results:
            shadow_ratio = results["shadow_ratio"]
            pack.add("shadow_ratio", shadow_ratio.square(), total)
        rgb = (static_ratio[..., None] * results["static_rgb"] * (1.0 - shadow_ratio)
               + dynamic_ratio[..., None] * results["dynamic_rgb"])
        pack.add("rgb", rgb, total)
        if decomp:
            pack.add("static_rgb", results["static_rgb"], static)
            if "shadow_ratio" in results:
                pack.add("shadow_reduced_static_rgb",
                         results["static_rgb"] * (1.0 - shadow_ratio), static)
                pack.add("shadow_only", results["static_rgb"] * shadow_ratio, static)
                pack.add("shadow", shadow_ratio, total)
            pack.add("dynamic_rgb", results["dynamic_rgb"], dynamic)
            if "forward_flow" in results:
                pack.add("forward_flow", results["forward_flow"], dynamic)
                pack.add("backward_flow", results["backward_flow"], dynamic)
    # ---------- features: in the same call as the other channels ----------
    if "dino_feat" in results:
        pack.add("dino_feat", results["dino_feat"], total)
    elif "static_dino_feat" in results and "dynamic_dino_feat" in results:
        pack.add("dino_feat", static_ratio[..., None] * results["static_dino_feat"]
                 + dynamic_ratio[..., None] * results["dynamic_dino_feat"], total)
        if decomp:
            pack.add("static_dino", results["static_dino_feat"], static)
            pack.add("dynamic_dino", results["dynamic_dino_feat"], dynamic)

    res = composite_along_rays(t_starts, t_ends, densities.contiguous(),
                               pack.values(), pack.sets)
    sums = pack.split(res.sums)
    weights = res.weights[..., total]

    extras = {
        "weights": weights,
        "trans": res.trans[..., total],
        "t_vals": (t_starts + t_ends) / 2.0,
        "t_dist": t_ends - t_starts,
        "density": density,
    }
    for k in _EXTRA_KEYS:
        if k in results:
            extras[k] = results[k]

    # ---------- geometry ----------
    opacity = res.opacity[:, total:total + 1]
    out: Dict[str, torch.Tensor] = {
        "depth": res.depth[:, total:total + 1],
        "opacity": opacity,
        "median_depth": res.median_depth,
    }

    # ---------- static / dynamic decomposition ----------
    if has_decomp:
        extras["static_density"] = results["static_density"]
        extras["dynamic_density"] = results["dynamic_density"]
        if decomp:
            out["static_opacity"] = res.opacity[:, static:static + 1]
            out["static_depth"] = res.depth[:, static:static + 1]
            out["dynamic_opacity"] = res.opacity[:, dynamic:dynamic + 1]
            out["dynamic_depth"] = res.depth[:, dynamic:dynamic + 1]

    # ---------- rgb and the other weighted sums ----------
    out.update(sums)
    if "shadow" in sums:
        out["shadow_only_static_rgb"] = out.pop("shadow_only") + (1.0 - sums["shadow"])

    # ---------- sky composition ----------
    if "rgb_sky" in results:
        out["rgb"] = out["rgb"] + results["rgb_sky"] * (1.0 - opacity)
        if "static_rgb" in out:
            out["static_rgb"] = out["static_rgb"] + results["rgb_sky"] * (
                1.0 - out["static_opacity"])

    # ---------- sky feature and the learnable-PE decomposition ----------
    if "dino_feat" in out:
        if "dino_sky_feat" in results:
            out["dino_feat"] = out["dino_feat"] + results["dino_sky_feat"] * (1.0 - opacity)
        if "dino_pe" in results:
            out["dino_pe_free"] = out["dino_feat"]
            out["dino_pe"] = results["dino_pe"]
            out["dino_feat"] = out["dino_feat"] + results["dino_pe"]
        if "static_dino" in out and "dino_sky_feat" in results:
            # the total opacity, as the reference composes it
            out["static_dino"] = out["static_dino"] + results["dino_sky_feat"] * (1.0 - opacity)

    out["extras"] = extras
    return out
