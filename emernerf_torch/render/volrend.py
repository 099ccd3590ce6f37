"""Volume rendering / alpha compositing (port of ``emernerf_tpu/render/volrend.py``).

``composite_along_rays`` is the differentiable wrapper around the K3 CUDA
kernels (``kernels/csrc/composite.cu``, forward and backward);
``composite_along_rays_ref`` and ``composite_along_rays_bwd_ref`` are their
plain versions.  One call computes, for up to three density sets (total,
static, dynamic), transmittance, weights, opacity and depth, the median
depth of the first set, and the weighted sums of a packed (R, S, C) value
tensor whose channel c is weighted by set ``chan_set[c]``.  Gradients flow
to the densities and the values (never to the sample edges).
``composite_rays`` is the dict glue around it and keeps the reference's
keys and formulas; every value channel of a render, the feature head's
included, goes into its one K3 call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from emernerf_torch import kernels
from emernerf_torch.ops.clip import clip
from emernerf_torch.ops.stepfuns import exclusive_cumsum

_MAX_SETS, _MAX_CHANNELS, _MAX_SAMPLES = 3, 256, 256
# above this many value channels a forward call is two launches: the
# weights, then composite_sums_kernel (composite.cu:kMaxStagedC)
_STAGED_CHANNELS = 64
_SET_WORDS = _MAX_CHANNELS // 32  # 2 bits per channel in 64-bit words


class Composited(NamedTuple):
    weights: torch.Tensor  # (R, S, D)
    trans: torch.Tensor  # (R, S, D)
    opacity: torch.Tensor  # (R, D), clipped to [1e-6, 1]
    depth: torch.Tensor  # (R, D)
    median_depth: torch.Tensor  # (R, 1), of density set 0
    sums: torch.Tensor  # (R, C)


@functools.lru_cache(maxsize=256)
def pack_chan_sets(chan_set: Tuple[int, ...], n_sets: int) -> Tuple[int, ...]:
    """The density set of each value channel, 2 bits per channel, as the K3
    kernels take them: eight 64-bit words, channel c in bits 2(c % 32) and
    2(c % 32) + 1 of word c // 32.  Cached per distinct tuple; raises on a
    set outside [0, n_sets) or over 256 channels."""
    if len(chan_set) > _MAX_CHANNELS or not 1 <= n_sets <= _MAX_SETS or any(
            not 0 <= c < n_sets for c in chan_set):
        raise ValueError("composite_along_rays: one density set per value channel")
    words = [0] * _SET_WORDS
    for c, dset in enumerate(chan_set):
        words[c >> 5] |= dset << (2 * (c & 31))
    return tuple(words)


@functools.lru_cache(maxsize=256)
def _chan_sets_arg(words: Tuple[int, ...]):
    """The packed words as the host array the C entry points copy."""
    return (ctypes.c_ulonglong * _SET_WORDS)(*words)


def _check_composite_args(name, t_starts, t_ends, densities, values, chan_set):
    if t_starts.ndim != 2 or t_ends.shape != t_starts.shape:
        raise ValueError(f"{name}: t_starts and t_ends must both be (R, S)")
    r, s = t_starts.shape
    if densities.ndim != 3 or densities.shape[:2] != (r, s) or not (
            1 <= densities.shape[2] <= _MAX_SETS):
        raise ValueError(f"{name}: densities must be (R, S, D<={_MAX_SETS})")
    if values is not None and (values.ndim != 3 or values.shape[:2] != (r, s)):
        raise ValueError(f"{name}: values must be (R, S, C)")
    if len(chan_set) != (0 if values is None else values.shape[2]):
        raise ValueError(f"{name}: one density set per value channel")
    pack_chan_sets(chan_set, densities.shape[2])  # validates each set once per tuple
    if s > _MAX_SAMPLES:
        raise ValueError(f"{name}: at most {_MAX_SAMPLES} samples per ray")
    if not (t_starts.dtype == t_ends.dtype == densities.dtype == torch.float32 and (
            values is None or values.dtype == torch.float32)):
        raise ValueError(f"{name}: float32 inputs required")


def composite_along_rays_ref(t_starts, t_ends, densities, values=None,
                             chan_set: Sequence[int] = ()) -> Composited:
    """Plain version of :func:`composite_along_rays`."""
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


def _composite_forward(t_starts, t_ends, densities, values, chan_set) -> Composited:
    """The K3 forward: plain version for CPU tensors, the kernel for CUDA.
    ``chan_set`` is a tuple that :func:`_check_composite_args` accepted."""
    name = "composite_along_rays"
    if kernels.dispatch_device(name, t_starts) == "cpu":
        return composite_along_rays_ref(t_starts, t_ends, densities, values, chan_set)
    extra = () if values is None else (values,)
    kernels.require_cuda_inputs(name, t_starts, t_ends, densities, *extra)
    r, s = t_starts.shape
    d, c = densities.shape[2], len(chan_set)
    # one buffer in the kernel's layout: weights, trans (R, S, D), opacity,
    # depth (R, D), median (R, 1), sums (R, C); as_strided is the cheapest
    # view on the host
    rsd, rd = r * s * d, r * d
    buf = torch.empty(r * (2 * s * d + 2 * d + 1 + c), dtype=torch.float32,
                      device=t_starts.device)
    view = buf.as_strided
    out = Composited(view((r, s, d), (s * d, d, 1)), view((r, s, d), (s * d, d, 1), rsd),
                     view((r, d), (d, 1), 2 * rsd), view((r, d), (d, 1), 2 * rsd + rd),
                     view((r, 1), (1, 1), 2 * rsd + 2 * rd),
                     view((r, c), (c, 1), 2 * rsd + 2 * rd + r))
    if r == 0:
        return out
    sets = _chan_sets_arg(pack_chan_sets(chan_set, d))
    err = kernels.load().emt_composite(
        t_starts.data_ptr(), t_ends.data_ptr(), densities.data_ptr(),
        None if values is None else values.data_ptr(), ctypes.addressof(sets), r, s, d, c,
        buf.data_ptr(), kernels.stream_ptr(t_starts.device))
    kernels.check(err, name)
    composite_along_rays.launches += 1 if c <= _STAGED_CHANNELS else 2
    return out


def composite_along_rays_bwd_ref(t_starts, t_ends, densities, values, chan_set,
                                 grads: Sequence[Optional[torch.Tensor]]):
    """Plain version of :func:`composite_along_rays_bwd`: autograd of the
    plain forward.  ``grads`` are the cotangents of (weights, trans, opacity,
    depth, sums), None for zeros; returns (d densities, d values or None)."""
    with torch.enable_grad():
        dens = densities.detach().requires_grad_(True)
        vals = None if values is None else values.detach().requires_grad_(True)
        out = composite_along_rays_ref(t_starts, t_ends, dens, vals, chan_set)
        pairs = [(o, g) for o, g in zip((out.weights, out.trans, out.opacity,
                                         out.depth, out.sums), grads) if g is not None]
        inputs = [dens] + ([vals] if vals is not None else [])
        if not pairs:
            return torch.zeros_like(densities), (
                None if values is None else torch.zeros_like(values))
        got = torch.autograd.grad([o for o, _ in pairs], inputs,
                                  [g for _, g in pairs], allow_unused=True)
    got = [torch.zeros_like(x) if g is None else g for g, x in zip(got, inputs)]
    return got[0], (got[1] if values is not None else None)


def composite_along_rays_bwd(t_starts, t_ends, densities, values, chan_set,
                             grads: Sequence[Optional[torch.Tensor]]):
    """K3 backward: d densities (R, S, D) and d values (R, S, C) from the
    cotangents of (weights, trans, opacity, depth, sums), None for zeros.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    name = "composite_along_rays_bwd"
    if kernels.dispatch_device(name, t_starts) == "cpu":
        return composite_along_rays_bwd_ref(t_starts, t_ends, densities, values,
                                            chan_set, grads)
    grads = [g if g is None or g.is_contiguous() else g.contiguous() for g in grads]
    extra = () if values is None else (values,)
    kernels.require_cuda_inputs(name, t_starts, t_ends, densities, *extra,
                                *[g for g in grads if g is not None])
    r, s = t_starts.shape
    d_dens = torch.empty_like(densities)
    # the kernel writes every d value when the sums have a cotangent
    d_vals = None if values is None else (
        torch.zeros_like(values) if grads[4] is None else torch.empty_like(values))
    if r == 0:
        return d_dens, d_vals
    d = densities.shape[2]
    sets = _chan_sets_arg(pack_chan_sets(tuple(chan_set), d))
    err = kernels.load().emt_composite_backward(
        t_starts.data_ptr(), t_ends.data_ptr(), densities.data_ptr(),
        None if values is None else values.data_ptr(), ctypes.addressof(sets), r, s, d,
        len(chan_set),
        *[None if g is None else g.data_ptr() for g in grads], d_dens.data_ptr(),
        None if d_vals is None else d_vals.data_ptr(), kernels.stream_ptr(t_starts.device),
    )
    kernels.check(err, name)
    composite_along_rays_bwd.launches += 1
    return d_dens, d_vals


composite_along_rays_bwd.launches = 0


class _Composite(torch.autograd.Function):
    """K3 forward and backward; the median depth carries no gradient."""

    @staticmethod
    def forward(ctx, t_starts, t_ends, densities, values, chan_set):
        ctx.set_materialize_grads(False)
        out = _composite_forward(t_starts, t_ends, densities, values, chan_set)
        ctx.save_for_backward(t_starts, t_ends, densities, values)
        ctx.chan_set = tuple(chan_set)
        ctx.mark_non_differentiable(out.median_depth)
        return tuple(out)

    @staticmethod
    def backward(ctx, g_w, g_t, g_o, g_d, _g_median, g_s):
        t_starts, t_ends, densities, values = ctx.saved_tensors
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise NotImplementedError("composite_along_rays: no gradient w.r.t. "
                                      "the sample edges (they are detached)")
        d_dens, d_vals = composite_along_rays_bwd(
            t_starts, t_ends, densities, values, ctx.chan_set, (g_w, g_t, g_o, g_d, g_s))
        return (None, None, d_dens if ctx.needs_input_grad[2] else None,
                d_vals if ctx.needs_input_grad[3] else None, None)


def composite_along_rays(t_starts: torch.Tensor, t_ends: torch.Tensor,
                         densities: torch.Tensor,
                         values: Optional[torch.Tensor] = None,
                         chan_set: Sequence[int] = ()) -> Composited:
    """Transmittance, weights and per-ray reductions for D density sets.

    t_starts/t_ends (R, S); densities (R, S, D); values (R, S, C) or None;
    chan_set: C ints, the density set that weights each value channel.
    Differentiable in densities and values.  CPU tensors take the plain
    versions; CUDA tensors launch the K3 kernels."""
    chan_set = tuple(chan_set)
    _check_composite_args("composite_along_rays", t_starts, t_ends, densities,
                          values, chan_set)
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in (
            t_starts, t_ends, densities, values)):
        return Composited(*_Composite.apply(t_starts, t_ends, densities, values, chan_set))
    return _composite_forward(t_starts, t_ends, densities, values, chan_set)


composite_along_rays.launches = 0


def weights_opacity_depth_from_density(t_starts, t_ends, density):
    """(weights (R, S), opacity (R, 1), depth (R, 1)) for one density."""
    res = composite_along_rays(t_starts, t_ends, density[..., None])
    return res.weights[..., 0], res.opacity, res.depth


class _Packer:
    """Collects (R, S, c) value blocks with their density set into one packed
    (R, S, C) tensor, and splits the kernel's (R, C) sums back by name."""

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
