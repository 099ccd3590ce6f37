"""The lidar branch's flow-MLP gradient at full width taken apart, in both
packages on the CPU: the diagnostics behind the module docstring of
``tests/test_torch_full_width_step.py`` (its ``FullWidth`` at one step).

    PYTHONPATH=.:tests python tests/full_width_flow_mlp.py \
        [--rays 2048] [--step 2300] [--smooth-dynamic] [--cycle-off] [--residual]

Without ``--residual`` each branch runs alone in the port from the
parameters JAX's ran on (the common state for the pixel branch, JAX's
post-pixel-update parameters for the lidar branch) and prints each
flow_mlp leaf's distance from JAX beside the port's own spread with the
ray origins one ulp apart, and the elements whose count-0 Adam step has
opposite signs in the two packages; ``--cycle-off`` sets the cycle loss's
coefficient to 0 in both step configs.  ``--residual`` takes the lidar
branch's flow-MLP gradient apart at the temporal aggregation's warped
points and at the samples' flow encoding: cells and bricks crossed, JAX's
position cotangent and flow encoding injected, and the path recomputed in
fp32 and float64.  At 2,048 + 2,048 rays with ``--smooth-dynamic`` a run
takes about 8 minutes and 20 GB of host memory.
"""

import contextlib
import sys

import jax
import numpy as np
import pytest
import torch
from jax_draw_tap import Tap
from test_torch_full_width_step import FullWidth, Selections, apart, jax_taps
from test_torch_train_step import _named

import emernerf_torch.models.fields as fields_mod
from emernerf_torch.ops.brickgrid import brickgrid_encode_ref


def _is_warp_query(xyzt) -> bool:
    """The temporal aggregation's fused query of the warped points: (2, R,
    K, 4), forward and backward warp stacked."""
    return xyzt.ndim == 4 and xyzt.shape[0] == 2 and xyzt.shape[-1] == 4


@contextlib.contextmanager
def jax_warp_tap():
    """(positions, cotangents, sample positions, sample encodings): every
    JAX warped-point query traced while open passes out its (2, R, K, 4)
    positions and, in the backward, their cotangent; every fused query of
    the samples themselves ((R, S, 4)) its positions and encoding (in trace
    order: the pixel branch's, then the lidar's)."""
    import emernerf_tpu.models.fields as jax_fields

    vals, cots, svals, senc = Tap(), Tap(), Tap(), Tap()

    @jax.custom_vjp
    def ident(x):
        return x

    def fwd(x):
        vals(x)
        return x, None

    def bwd(_, g):
        cots(g)
        return (g,)

    ident.defvjp(fwd, bwd)
    encode = jax_fields.grid_encode

    def wrapped(table, xyzt, spec, *a, **kw):
        if _is_warp_query(xyzt):
            return encode(table, ident(xyzt), spec, *a, **kw)
        out = encode(table, xyzt, spec, *a, **kw)
        if xyzt.ndim == 3 and xyzt.shape[-1] == 4:
            svals(xyzt)
            senc(out)
        return out

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_fields, "grid_encode", wrapped)
        yield vals, cots, svals, senc


class PortWarp:
    """The port's side of the residual: its warped-point query's positions,
    their cotangent (``inject``: a function that replaces it) and the
    encoding's cotangent, and the inputs of the flow MLP and of the top-K
    aggregation."""

    def __init__(self, inject=None, flow_in=None):
        """``flow_in``: a flow encoding of the samples that replaces the
        port's as the flow MLP's input."""
        self.inject, self.replace_flow_in = inject, flow_in
        self.pos = self.cot = self.enc_cot = self.flow_in = self.agg_in = None
        self.sample_pos = None

    def patch(self, m):
        encode, agg = fields_mod.grid_encode, fields_mod.RadianceField._topk_aggregation
        flow = fields_mod.RadianceField._fused_flow
        rec = self

        def grid_encode(table, xyzt, spec, *a, **kw):
            if not (_is_warp_query(xyzt) and xyzt.requires_grad):
                return encode(table, xyzt, spec, *a, **kw)
            rec.pos = xyzt.detach().clone()

            def hook(g):
                rec.cot = g.detach().clone()
                return None if rec.inject is None else rec.inject(g)

            xyzt.register_hook(hook)
            out = encode(table, xyzt, spec, *a, **kw)
            out.register_hook(lambda g: setattr(rec, "enc_cot", g.detach().clone()))
            return out

        def fused_flow(self_, normed, t, flow_enc, train):
            if normed.ndim == 3:  # the samples' own query, (R, S, 3)
                rec.sample_pos = torch.cat([normed, t[..., None]], -1).detach().clone()
                if rec.replace_flow_in is not None:
                    flow_enc = rec.replace_flow_in.to(flow_enc.dtype)
                rec.flow_in = flow_enc.detach().clone()
            return flow(self_, normed, t, flow_enc, train)

        def topk_aggregation(self_, *a, **kw):
            rec.agg_in = [x.detach().clone() if torch.is_tensor(x) else x for x in a]
            return agg(self_, *a, **kw)

        m.setattr(fields_mod, "grid_encode", grid_encode)
        m.setattr(fields_mod.RadianceField, "_fused_flow", fused_flow)
        m.setattr(fields_mod.RadianceField, "_topk_aggregation", topk_aggregation)


def flow_segment(model, warp: PortWarp, idx, dtype):
    """The flow MLP's gradients of the lidar branch, recomputed in ``dtype``
    along the one path they take there: the samples' flow (the flow MLP on
    the port's fp32 flow encoding), the K selected samples warped forward
    and backward by it (``contract_points``), the fused grid read at the
    warped points, and the port's fp32 cotangent of that encoding."""
    positions, t, ff, bf, cur, noise, k = warp.agg_in[:7]
    layers = [(lay.weight.detach().to(dtype).requires_grad_(),
               lay.bias.detach().to(dtype).requires_grad_()) for lay in model.flow_mlp.layers]
    x = warp.flow_in.to(dtype)
    for i, (w, b) in enumerate(layers):
        x = torch.nn.functional.linear(x, w, b)
        if i < len(layers) - 1:
            x = torch.relu(x)

    def sel(v):
        return torch.gather(v, 1, idx[..., None].expand(-1, -1, v.shape[-1]))

    pos_k, noise_k = sel(positions.to(dtype)), sel(noise.to(dtype))
    warped = torch.stack([model.contract_points(pos_k + sel(x[..., :3]) * noise_k),
                          model.contract_points(pos_k + sel(x[..., 3:]) * noise_k)])
    xyzt = torch.cat([warped, warp.pos[..., 3:].to(dtype)], -1)
    # the plain reference in ``dtype``, differentiable in the positions
    enc = brickgrid_encode_ref(model.dynflow_table.detach().to(dtype), xyzt, model.dynflow_spec,
                               accum_dtype=dtype)
    (enc * warp.enc_cot.to(dtype)).sum().backward()
    names = [f"flow_mlp.layers.{i}.{n}" for i in range(len(layers)) for n in ("weight", "bias")]
    return dict(zip(names, [g.grad.double() for wb in layers for g in wb])), xyzt.detach()


def _cells(x, spec):
    """Each level's cell index per spatial axis of fp32 positions (the
    packages' ``floor(x * scale + 0.5)``, each op rounded): (L, ..., 3)."""
    from emernerf_torch.ops.brickgrid import level_constants

    x = torch.as_tensor(np.asarray(x, np.float32))[..., :3]
    return torch.stack([torch.floor((x * float(sc)) + 0.5)
                        for sc in level_constants(spec)[0][:spec.n_levels_used]])


def residual(fw, rec, jpos, jcot, jspos, jsenc, m):
    """The lidar branch's flow-MLP gradient from the parameters JAX's ran
    on, taken apart at the warped points and at the samples' flow encoding
    (module docstring's ``--residual``)."""
    jg = _named(rec["grads"][3], False)
    model = fw.tstate.model
    spec = model.dynflow_spec
    df = model.dynamic_spec.n_features_per_level
    jsenc = torch.from_numpy(np.asarray(jsenc))
    jflow_in = jsenc.reshape(*jsenc.shape[:-1], spec.n_levels, -1)[..., df:].flatten(-2)

    def lidar(inject=None, flow_in=None):
        warp = PortWarp(inject, flow_in)
        with m.context() as mm:
            warp.patch(mm)
            _, (_, tg) = fw.branch(rec, True, mm)
        idx = [i for site, i in fw.selections.chosen if site == "aggregation"][0]
        return warp, {n: g.double() for n, g in zip(fw.names, tg) if n.startswith("flow_mlp.")}, idx

    def dist(a, b):
        return {n: float((a[n] - b[n]).abs().max() / jg[n].abs().max()) for n in a}

    warp, port, idx = lidar()
    jax_ = {n: jg[n].double() for n in port}
    jpos, jcot = torch.from_numpy(np.asarray(jpos)), torch.from_numpy(np.asarray(jcot))
    pp, pc = warp.pos, warp.cot
    ulps = ((pp - jpos).abs() / torch.from_numpy(np.spacing(np.abs(jpos.numpy()))))[..., :3]
    cross_lvl = (_cells(pp, spec) != _cells(jpos, spec)).any(-1)  # (L, 2, R, K)
    cross = cross_lvl.any(0)
    dc = (pc - jcot)[..., :3].abs().sum(-1)
    print(f"  warped points {tuple(pp.shape[:3])}: positions apart by up to "
          f"{float(ulps.max()):.0f} ulp (median {float(ulps.median()):.1f}); JAX's and the "
          f"port's in different cells at "
          f"some level: {int(cross.sum())} points of {cross.numel()} "
          f"(per level {cross_lvl.flatten(1).sum(1).tolist()})")
    print(f"  position cotangent |port - JAX| (sum over x, y, z): total {float(dc.sum()):.4e}, "
          f"on the points in different cells {float(dc[cross].sum()):.4e}; largest on one "
          f"point elsewhere {float(dc[~cross].max()):.3e}, on one in different cells "
          f"{float(dc[cross].max()) if cross.any() else 0.0:.3e}")
    print(f"  port vs JAX: {dist(port, jax_)}")
    _, every, _ = lidar(lambda g: jcot.to(g.dtype))
    print(f"  JAX's position cotangent injected at every warped point: {dist(every, jax_)}")
    _, crossed, _ = lidar(lambda g: torch.where(cross[..., None], jcot.to(g.dtype), g))
    print(f"  ... only at the points in different cells: {dist(crossed, jax_)}")
    sp = warp.sample_pos
    jsp = torch.from_numpy(np.asarray(jspos))
    s_ulps = ((sp - jsp).abs() / torch.from_numpy(np.spacing(np.abs(jsp.numpy()))))[..., :3]
    s_cells = _cells(sp, spec), _cells(jsp, spec)
    s_cross = (s_cells[0] != s_cells[1]).any(-1).any(0)
    bricks = [torch.div(c, spec.brick_cells, rounding_mode="floor") for c in s_cells]
    s_brick = (bricks[0] != bricks[1]).any(-1).any(0)
    d_in = (warp.flow_in - jflow_in).abs().amax(-1)
    print(f"  samples {tuple(sp.shape[:2])}: positions apart by up to "
          f"{float(s_ulps.max()):.0f} ulp; in different cells at some level {int(s_cross.sum())}, in different bricks "
          f"{int(s_brick.sum())}; flow encoding |port - JAX| largest {float(d_in.max()):.3e} "
          f"(max |JAX| {float(jflow_in.abs().max()):.3e}), off those in different bricks "
          f"{float(d_in[~s_brick].max()):.3e}")
    _, both, _ = lidar(lambda g: jcot.to(g.dtype), jflow_in)
    print(f"  JAX's position cotangent at the warped points and JAX's flow encoding of the "
          f"samples injected: {dist(both, jax_)}")
    seg64, x64 = flow_segment(model, warp, idx, torch.float64)
    seg32, _ = flow_segment(model, warp, idx, torch.float32)
    print(f"  the segment in fp32 vs the port: {dist(seg32, port)}")
    print(f"  the segment in float64 vs the port: {dist(seg64, port)}")
    print(f"  the segment in float64 vs JAX: {dist(seg64, jax_)}")
    c64 = _cells(x64.float().numpy(), spec)
    print(f"  float64 warped points in another cell than the port's: "
          f"{int((c64 != _cells(pp, spec)).any(-1).any(0).sum())}, than JAX's: "
          f"{int((c64 != _cells(jpos, spec)).any(-1).any(0).sum())}")




def branches(fw, rec, m):
    """Each branch of ``rec`` alone in the port, from the parameters JAX's
    ran on: the losses, every flow_mlp leaf's distance from JAX, and the
    port's own spread there with the ray origins one ulp apart."""
    jm = rec["metrics"]
    for lidar, (gp, gm) in ((False, rec["grads"][:2]), (True, rec["grads"][2:])):
        tm, (tp, tg) = fw.branch(rec, lidar, m)
        sel = fw.selections
        _, (_, nudged) = fw.branch(rec, lidar, m, Selections(rec["topk"], tie=float("inf")),
                                   nudge=True)
        name = "lidar" if lidar else "pixel"
        rel = {k: abs(v - jm[k]) / max(abs(jm[k]), 1e-30) for k, v in tm.items() if k in jm}
        print(f"  {name} branch alone: selections {sel.paired}, ties {sel.ties}\n"
              f"    losses, relative to JAX: {rel}")
        own = {n: float((b - a).abs().max()) / max(float(a.abs().max()), 1e-30)
               for n, a, b in zip(fw.names, tg, nudged) if n.startswith("flow_mlp.")}
        for n, v in apart(gm, tg, fw.names, False, "flow_mlp.").items():
            print(f"    {n:28s} apart from JAX {v:.3e}; the port's one-ulp spread {own[n]:.3e}")
        worst = max(apart(gm, tg, fw.names, False).items(), key=lambda kv: kv[1])
        worst_p = max(apart(gp, tp, fw.prop_names, True).items(), key=lambda kv: kv[1])
        print(f"    the farthest model leaf {worst}, proposal leaf {worst_p}")
        if not lidar:
            # Adam at count 0 moves an element by lr * sign(g + wd p)
            wd, ref = fw.tcfg.weight_decay, _named(gm, False)
            params = _named(fw.init.params, False)
            flips = {n: int(((ref[n] + wd * params[n]).sign() * (t + wd * params[n]).sign()
                             < 0).sum()) for n, t in zip(fw.names, tg) if t is not None}
            print(f"    elements whose count-0 Adam step has opposite signs in the two "
                  f"packages: {sum(flips.values())}, in dynflow_table "
                  f"{flips.get('dynflow_table', 0)} of {params['dynflow_table'].numel()}")


def main(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rays", type=int, default=2048)
    p.add_argument("--step", type=int, default=2300)
    p.add_argument("--smooth-dynamic", action="store_true",
                   help="leave the fused dynamic-and-flow table at JAX's initializer's "
                        "U(+-1e-4), so that a brick face moves its encoding 2000x less")
    p.add_argument("--cycle-off", action="store_true",
                   help="the cycle loss's coefficient 0 in both step configs")
    p.add_argument("--residual", action="store_true",
                   help="take the lidar branch's flow-MLP gradient apart (module docstring)")
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(8)

    warp_tap = jax_warp_tap() if args.residual else contextlib.nullcontext()
    with jax_taps() as taps, warp_tap as warps, pytest.MonkeyPatch.context() as m:
        fw = FullWidth(taps, rays=args.rays,
                       unscaled=("dynflow_table",) if args.smooth_dynamic else (),
                       cycle_coef=0.0 if args.cycle_off else None)
        rec = fw.jax_run(args.step)
        print(f"step {args.step} rays {args.rays}+{args.rays}")
        if args.residual:  # the lidar branch's (the last) of each tap
            residual(fw, rec, *(t.take()[-1] for t in warps), m)
        else:
            branches(fw, rec, m)


if __name__ == "__main__":
    main(sys.argv[1:])
