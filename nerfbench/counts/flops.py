"""The model FLOPs of one training iteration or one eval frame, from the
configuration's widths and the traffic's ray and sample counts alone, so
that a change of implementation cannot make them stale.

- Every MLP layer: 2 in out per sample it evaluates forward, twice that
  backward; at the peak of the configuration's ``mlp_dtype``.
- Every grid call: ``grids.grid_ops`` forward, and backward (with the
  position gradient for the flow-warped queries); at the fp32 peak.

Per render of R rays (S final samples, proposal samples P_i): proposal
net i at R P_i samples; with top-K pruning (0 < K < S) the last proposal
net once more at R S (no gradient) and the field at R K, else at R S.  The
field: the static grid and base MLP; with the dynamic branch the dynamic
grid and base MLP and the flow (one fused 4D grid on the brick backend,
else separate dynamic and flow grids); the temporal aggregation at two
warped copies of the A most dynamic samples (A = temporal_agg_topk where
0 < A < Q on a fused grid, else all Q; the separate dynamic grid takes the
current and both warped queries in one 3Q call, the flow grid the two
warped); then, unless the render is lidar (density only), the rgb head
twice (static, dynamic), the shadow head, and the sky head once a ray.
With the feature head, the same renders add the DINO head at each shaded
sample of each branch (static, dynamic) and, once a ray, its sky head and
the learnable PE map's head (the map's bilinear sample is not counted);
their backward only where the configuration loads features, since without
the feature loss no gradient reaches them.
A training iteration is a pixel and a lidar render, each with its
backward; the proposal nets' backward runs on the share of renders that
carries proposal gradients (``rg_share``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from nerfbench.counts import grids, peaks

PROP_MLP_WIDTH = 64  # DensityField's base MLP width, fixed by the architecture


def _cfg(config, workload):
    from nerfbench.reference.plain.config import ConfigNode

    cfg = ConfigNode(config["cfg"])
    for key, value in workload.get("overrides", {}).items():
        cfg.set_dotted(key, value)
    return cfg


def _specs(cfg):
    """The grid specs: props, static, dynamic, flow (as the builders make them)."""
    from nerfbench.reference.plain import builders

    backend = cfg.nerf.model.get("grid_backend", "brick")
    pair, perf = builders.cfg_time_pair(cfg), builders.cfg_perf(cfg)
    m, enc = cfg.nerf.model, cfg.nerf.propnet.xyz_encoder
    props = [builders.make_grid_spec(backend, 3, enc.n_levels_per_prop[i],
                                     enc.base_resolutions_per_prop[i],
                                     enc.max_resolution_per_prop[i],
                                     enc.lgo2_hashmap_size_per_prop[i],
                                     enc.n_features_per_level, perf=perf)
             for i in range(len(cfg.nerf.propnet.num_samples_per_prop))]
    static = builders._enc_spec(m.xyz_encoder, backend, pair, perf)
    dyn = (builders._enc_spec(m.dynamic_xyz_encoder, backend, pair, perf)
           if m.head.enable_dynamic_branch else None)
    flow = builders.flow_spec(backend, pair, perf) if m.head.enable_flow_branch else None
    fused = (bool(m.get("fuse_flow_grid", backend in ("brick", "mx")))
             and dyn is not None and flow is not None)
    return props, static, dyn, flow, fused


def _mlps(cfg, static, dyn, flow, fused) -> Dict[str, List[Tuple[int, int]]]:
    m = cfg.nerf.model
    gf, bw, hw = m.neck.geometry_feature_dim, m.neck.base_mlp_layer_width, \
        m.head.head_mlp_layer_width
    head = m.head
    sf = m.neck.semantic_feature_dim if head.enable_feature_head else 0
    dir_dim = 33  # sinusoidal_output_dim(3): identity + 5 octaves of sin and cos
    app = head.appearance_embedding_dim if (head.enable_img_embedding
                                            or head.enable_cam_embedding) else 0
    hin = dir_dim + app
    out = {"static": [(static.n_output_dims, bw), (bw, gf + sf)],
           "rgb": [(hin + gf, hw), (hw + hin + gf, hw), (hw, 3)]}
    if dyn is not None:
        out["dynamic"] = [(dyn.n_output_dims, bw), (bw, gf + sf)]
    if flow is not None:
        levels = (dyn if fused else flow).n_levels
        out["flow"] = [(levels * flow.n_features_per_level, bw), (bw, bw), (bw, 6)]
    if head.enable_shadow_head:
        out["shadow"] = [(gf, bw), (bw, 1)]
    if head.enable_sky_head:
        out["sky"] = [(hin, hw), (hw + hin, hw), (hw, 3)]
    if head.enable_feature_head:
        # the head's output width is the feature maps' where the scene has them
        pix = cfg.data.pixel_source
        fw = head.feature_mlp_layer_width
        fe = int(pix.target_feature_dim if pix.load_features else head.feature_embedding_dim)
        out["dino"] = [(sf, fw), (fw, fw), (fw, fe)]
        if head.enable_sky_head:
            out["dino_sky"] = [(hin, fw), (fw, fw), (fw, fe)]
        if head.enable_learnable_pe:
            out["pe"] = [(fe // 2, fe)]
    return out


def _mlp_flops(layers) -> float:
    return float(sum(2 * i * o for i, o in layers))


def _render(cfg, rays: int, samples: int, topk: int, lidar: bool, grad: bool,
            prop_grad_share: float) -> Tuple[float, float]:
    """(MLP FLOPs, grid operations) of one render, forward and backward."""
    props, static, dyn, flow, fused = _specs(cfg)
    mlps = _mlps(cfg, static, dyn, flow, fused)
    prop_samples = [int(v) for v in cfg.nerf.propnet.num_samples_per_prop]
    bwd = 2.0 if grad else 0.0
    mlp = grid = 0.0
    prop_layers = lambda spec: [(spec.n_output_dims, PROP_MLP_WIDTH), (PROP_MLP_WIDTH, 1)]
    for spec, p in zip(props, prop_samples):
        n = rays * p
        mlp += _mlp_flops(prop_layers(spec)) * n * (1 + bwd * prop_grad_share)
        grid += grids.grid_ops(spec, n, False, False)
        grid += prop_grad_share * grids.grid_ops(spec, n, True, False) if grad else 0.0
    prune = 0 < topk < samples
    q = topk if prune else samples
    if prune:  # the last proposal net once more, at every final sample, no gradient
        n = rays * samples
        mlp += _mlp_flops(prop_layers(props[-1])) * n
        grid += grids.grid_ops(props[-1], n, False, False)

    def field_grid(spec, n, pos_grad=False):
        return grids.grid_ops(spec, n, False, False) + (
            grids.grid_ops(spec, n, True, pos_grad) if grad else 0.0)

    nq = rays * q
    mlp += _mlp_flops(mlps["static"]) * nq * (1 + bwd)
    grid += field_grid(static, nq)
    if dyn is not None:
        agg = int(cfg.nerf.model.head.get("temporal_agg_topk", 0))
        a = agg if (fused and flow is not None and 0 < agg < q) else q
        if flow is None:
            mlp += _mlp_flops(mlps["dynamic"]) * nq * (1 + bwd)
            grid += field_grid(dyn, nq)
        elif fused:
            import dataclasses

            dynflow = dataclasses.replace(dyn, n_features_per_level=dyn.n_features_per_level
                                          + flow.n_features_per_level)
            nw = 2 * rays * a
            grid += field_grid(dynflow, nq) + field_grid(dynflow, nw, pos_grad=True)
            mlp += (_mlp_flops(mlps["dynamic"]) + _mlp_flops(mlps["flow"])) * (nq + nw) * (1 + bwd)
        else:
            nw = 2 * rays * a
            grid += field_grid(dyn, nq + nw, pos_grad=True)
            grid += field_grid(flow, nq) + field_grid(flow, nw, pos_grad=True)
            mlp += (_mlp_flops(mlps["dynamic"]) + _mlp_flops(mlps["flow"])) * (nq + nw) * (1 + bwd)
    if not lidar:
        per_sample = 2 * _mlp_flops(mlps["rgb"]) + _mlp_flops(mlps.get("shadow", []))
        mlp += per_sample * nq * (1 + bwd)
        mlp += _mlp_flops(mlps.get("sky", [])) * rays * (1 + bwd)
        if "dino" in mlps:
            fbwd = bwd if cfg.data.pixel_source.load_features else 0.0
            branches = 2 if dyn is not None else 1
            mlp += branches * _mlp_flops(mlps["dino"]) * nq * (1 + fbwd)
            mlp += (_mlp_flops(mlps.get("dino_sky", [])) + _mlp_flops(mlps.get("pe", []))) \
                * rays * (1 + fbwd)
    return mlp, grid


def least_seconds(cfg, mlp: float, grid: float) -> float:
    return mlp / peaks.flops_per_s(cfg.nerf.model.get("mlp_dtype", "float32")) \
        + grid / peaks.FP32_FLOPS


def train_iteration(config, workload) -> Dict[str, float]:
    """{mlp, grid, least_s} of one training iteration of the cell."""
    cfg = _cfg(config, workload)
    rays = int(cfg.data.ray_batch_size)
    s = int(cfg.nerf.sampling.num_samples)
    k = int(cfg.nerf.sampling.get("sample_topk", 0))
    lk = int(cfg.nerf.sampling.get("lidar_sample_topk", -1))
    lk = k if lk < 0 else lk
    share = float(workload["rg_share"])
    mp, gp = _render(cfg, rays, s, k, False, True, share)
    ml, gl = _render(cfg, rays, s, lk, True, True, share)
    mlp, grid = mp + ml, gp + gl
    return {"mlp": mlp, "grid": grid, "least_s": least_seconds(cfg, mlp, grid)}


def eval_frame(config, workload) -> Dict[str, float]:
    """{mlp, grid, least_s} of one eval frame of the cell (every pixel)."""
    cfg = _cfg(config, workload)
    rays = int(cfg.data.synthetic.image_height) * int(cfg.data.synthetic.image_width)
    s = int(cfg.nerf.sampling.num_samples)
    k = int(cfg.get_dotted("render.eval_sample_topk", 0))
    mlp, grid = _render(cfg, rays, s, k, False, False, 0.0)
    return {"mlp": mlp, "grid": grid, "least_s": least_seconds(cfg, mlp, grid)}
