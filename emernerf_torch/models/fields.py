"""EmerNeRF fields (port of ``emernerf_tpu/models/fields.py``), eval and
train paths.

``RadianceField``: the static grid field; the dynamic and flow grids, fused
into one 4D grid (per level the lanes are ``[dyn F_d | flow F_f]``, the
brick profile's default) or separate (``dynamic_table`` and ``flow_table``,
the reference-semantics profiles); the flow MLP; temporal aggregation of
flow-warped features (Eq. 8), on all samples or, fused, on the K most
dynamic samples per ray; or the dynamic grid alone, without flow or
aggregation (``configs/default_dynamic.yaml``); the shared RGB head, shadow
and sky heads, and the appearance embedding with its mean-embedding
fallback; the feature head: the base MLPs' output split into geometry and
semantic features, the DINO head over the semantic ones (and its sky
head), and the learnable positional-embedding map, sampled at the ray's
pixel and lifted by its own head.  ``DensityField``:
the proposal network, optionally with fine-level skipping.

Positions are (R, S, 3) and per-ray data is expanded to (R, S) by the
renderer; the point queries ``query_flow`` and ``query_attributes`` (flow
eval, voxel export) take (N, 3) positions and (N,) timestamps.  Training
differs from eval in the aggregation noise (a tensor of uniform draws
instead of 1), ``return_density_only`` for the lidar render and the
``train`` flag, which only turns off the eval-time temporal interpolation:
with ``enable_temporal_interpolation`` the flow field is queried at the two
training timesteps nearest each ray's (or point batch's) time and the two
encodings (or, without ``interpolate_xyz_encoding``, the two flow MLP
outputs) are lerped.  The flow-warped 4D queries are the grid queries whose
positions carry a gradient (they depend on the flow MLP).  The rgb and sky
heads read the directions through the sinusoidal encoding or, with
``direction_encoding="sh"``, spherical harmonics of degree 4.  Every grid
is a brick grid (K1), an exact hash grid (K4) or an MX grid (K1 + K12), by
its spec's type; a fused MX grid widens the dynamic spec's features as a
fused brick grid does.  The flow branch without the dynamic branch raises
in ``emernerf_torch/builders.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from emernerf_torch.models.init_utils import torch_embedding_init_
from emernerf_torch.models.mlp import MLP, Sequential64
from emernerf_torch.ops.activations import density_activation
from emernerf_torch.ops.brickgrid import BrickGridSpec
from emernerf_torch.ops.contraction import (
    contract_merf,
    inside_unit_cube_selector,
    normalize_aabb,
)
from emernerf_torch.ops.grid import grid_encode, init_grid_table
from emernerf_torch.ops.interp import grid_sample_2d
from emernerf_torch.ops.sh import sh_encode, sh_output_dim
from emernerf_torch.ops.sinusoidal import sinusoidal_encode, sinusoidal_output_dim


# the learnable PE map's (height, width): the reference's, which no config sets
PE_MAP_HW = (80, 120)


# entries of one one-hot block in the embedding's gradient (rows x indices;
# 128 MiB in float64): every stock table takes one block at 8,192 rays
_EMBED_ONE_HOT_ENTRIES = 1 << 24


class _EmbeddingLookup(torch.autograd.Function):
    """``weight[idx]`` whose table gradient is a float64 one-hot product per
    block of rows (cuBLAS reduces in a fixed order, and float64 takes no
    TF32), rounded once to the table's dtype, not ``nn.Embedding``'s
    backward, whose sums over repeated indices come out in a run-dependent
    order on the card: the gradient is bit for bit from run to run."""

    @staticmethod
    def forward(ctx, weight, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.dtype = weight.shape[0], weight.dtype
        return torch.index_select(weight, 0, idx.reshape(-1)).view(*idx.shape, weight.shape[1])

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        flat_idx = idx.reshape(-1)
        flat_grad = grad.reshape(-1, grad.shape[-1]).double()
        block = max(1, _EMBED_ONE_HOT_ENTRIES // max(1, flat_idx.numel()))
        parts = []
        for lo in range(0, ctx.n_rows, block):
            rows = torch.arange(lo, min(lo + block, ctx.n_rows), device=idx.device)
            parts.append((rows[:, None] == flat_idx).double() @ flat_grad)
        out = parts[0] if len(parts) == 1 else torch.cat(parts)
        return out.to(ctx.dtype), None


def embedding_lookup(weight: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The rows ``idx`` (any shape, any integer dtype) of ``weight``:
    (*idx.shape, D), differentiable in ``weight`` with a run-to-run
    deterministic gradient.  Dimensions along which ``idx`` is an expanded
    view (stride 0, as the renderer expands each ray's index over its
    samples) are looked up once and expanded: their gradient is a sum over
    that dimension before the one-hot product sees one index per ray."""
    shape = idx.shape
    for d in range(idx.ndim):
        if idx.stride(d) == 0 and idx.shape[d] > 1:
            idx = idx.narrow(d, 0, 1)
    out = _EmbeddingLookup.apply(weight, idx.long())
    return out if idx.shape == shape else out.expand(*shape, weight.shape[-1])


def find_topk_nearby_timesteps(training_timesteps: torch.Tensor, query: torch.Tensor,
                               topk: int = 2) -> torch.Tensor:
    """The ``topk`` training timesteps (T,) nearest each query (...,), nearest
    first: (..., topk).  A stable sort of the distances puts the lower index
    first on ties, as ``jax.lax.top_k`` does; ``torch.topk`` does not."""
    diffs = (training_timesteps[None, :] - query.reshape(-1)[:, None]).abs()
    idx = torch.sort(diffs, dim=-1, stable=True)[1][:, :topk]
    return training_timesteps[idx].reshape(*query.shape, topk)


def _contract(positions, aabb, unbounded: bool):
    """World -> [0,1]^3, out-of-box points zeroed."""
    normed = contract_merf(positions, aabb) if unbounded else normalize_aabb(positions, aabb)
    return normed * inside_unit_cube_selector(normed)[..., None]


class DensityField(nn.Module):
    """Proposal density network: grid encoder + 2-layer MLP -> density.

    ``fine_level_skip`` k > 0 (a 3D brick grid only): the finest k levels
    are read only by the first ``s_near`` samples of each ray (sample axis
    -2, sorted near to far); the far samples read a coarse view of the same
    table and their fine features are zero."""

    def __init__(self, spec, aabb: Tuple[float, ...] = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0),
                 unbounded: bool = True, base_mlp_layer_width: int = 64,
                 table_dtype=torch.float32, table_param_dtype=torch.float32,
                 mlp_dtype=torch.float32, fine_level_skip: int = 0,
                 fine_level_frac: float = 0.5, device=None, generator=None):
        super().__init__()
        self.spec = spec
        self.unbounded = unbounded
        self.table_dtype = table_dtype
        self.fine_level_skip, self.fine_level_frac = fine_level_skip, fine_level_frac
        self.register_buffer("aabb", torch.tensor(aabb, dtype=torch.float32,
                                                  device=device), persistent=False)
        self.hash_table = nn.Parameter(init_grid_table(
            spec, table_param_dtype, device=device, generator=generator))
        self.base_mlp = Sequential64(spec.n_output_dims, (base_mlp_layer_width, 1),
                                     dtype=mlp_dtype, device=device, generator=generator)

    def _encode(self, normed: torch.Tensor) -> torch.Tensor:
        k, spec = self.fine_level_skip, self.spec
        if k > 0:
            if not isinstance(spec, BrickGridSpec) or spec.has_time:
                raise ValueError(
                    f"fine_level_skip requires a 3D brick-grid spec (got {type(spec).__name__})")
            if k >= spec.n_levels:
                raise ValueError(f"fine_level_skip={k} must be < n_levels={spec.n_levels}")
        # flat point queries have no near/far structure: the full encode
        if k <= 0 or normed.dim() < 3:
            return grid_encode(self.hash_table, normed.contiguous(), spec, self.table_dtype)
        s = normed.shape[-2]
        # ceil(frac * S) near samples, down to a multiple of 8 (at least 8)
        s_near = min(s, max(1, math.ceil(s * self.fine_level_frac)))
        s_near = max(8, (s_near // 8) * 8)
        if s_near >= s:
            raise ValueError(
                f"fine_level_skip={k} cannot engage: sample count {s} with fine_level_frac="
                f"{self.fine_level_frac} leaves no far segment (need > {s_near} samples on "
                "the sorted axis); raise num_samples_per_prop or disable the knob")
        coarse = spec.n_levels - k
        cspec = dataclasses.replace(spec, view_levels=coarse)
        ctable = self.hash_table[:coarse * spec.bricks_per_level]
        enc_n = grid_encode(self.hash_table, normed[..., :s_near, :].contiguous(), spec,
                            self.table_dtype)
        enc_f = grid_encode(ctable, normed[..., s_near:, :].contiguous(), cspec,
                            self.table_dtype)
        enc_f = torch.cat([enc_f, enc_f.new_zeros(*enc_f.shape[:-1],
                                                  k * spec.n_features_per_level)], -1)
        return torch.cat([enc_n, enc_f], -2)

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        """positions (..., 3) world coords -> density (...,).  With
        fine-level skipping the sample axis (-2) is sorted near to far."""
        normed = _contract(positions, self.aabb, self.unbounded)
        enc = self._encode(normed).float()
        return density_activation(self.base_mlp(enc)[..., 0])


class RadianceField(nn.Module):
    def __init__(self, static_spec, dynamic_spec=None, flow_spec=None,
                 fuse_flow_grid: bool = True, temporal_agg_topk: int = 0,
                 aabb: Tuple[float, ...] = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0),
                 unbounded: bool = True, geometry_feature_dim: int = 64,
                 base_mlp_layer_width: int = 64, head_mlp_layer_width: int = 64,
                 enable_cam_embedding: bool = False,
                 enable_img_embedding: bool = False, num_cams: int = 3,
                 appearance_embedding_dim: int = 16,
                 enable_sky_head: bool = False, enable_shadow_head: bool = False,
                 semantic_feature_dim: int = 0, feature_mlp_layer_width: int = 64,
                 feature_embedding_dim: int = 64, enable_feature_head: bool = False,
                 enable_learnable_pe: bool = True,
                 num_train_timesteps: int = 0, time_diff: float = 0.0,
                 table_dtype=torch.float32, table_param_dtype=torch.float32,
                 mlp_dtype=torch.float32, direction_encoding: str = "sinusoidal",
                 enable_temporal_interpolation: bool = False,
                 interpolate_xyz_encoding: bool = True,
                 training_timesteps: Optional[torch.Tensor] = None,
                 device=None, generator=None):
        """``direction_encoding``: "sinusoidal" or "sh" (degree 4) for the
        rgb and sky heads; ``training_timesteps`` (T,): the normalized
        timesteps of the training images, where the eval-time temporal
        interpolation (``enable_temporal_interpolation``) anchors the flow."""
        super().__init__()
        if direction_encoding not in ("sinusoidal", "sh"):
            raise ValueError(f"unknown direction encoding {direction_encoding!r}")
        if flow_spec is not None and dynamic_spec is None:
            raise NotImplementedError("the flow branch needs the dynamic branch")
        self.static_spec = static_spec
        self.dynamic_spec = dynamic_spec
        self.flow_spec = flow_spec
        self.fuse_flow_grid = fuse_flow_grid
        self.temporal_agg_topk = temporal_agg_topk
        self.unbounded = unbounded
        self.geometry_feature_dim = gf = geometry_feature_dim
        sf = semantic_feature_dim
        self.enable_cam_embedding = enable_cam_embedding
        self.enable_img_embedding = enable_img_embedding
        self.appearance_embedding_dim = appearance_embedding_dim
        self.enable_sky_head = enable_sky_head
        self.enable_shadow_head = enable_shadow_head
        self.enable_feature_head = enable_feature_head
        self.enable_learnable_pe = enable_feature_head and enable_learnable_pe
        self.time_diff = time_diff
        self.table_dtype = table_dtype
        self.direction_encoding = direction_encoding
        self.enable_temporal_interpolation = enable_temporal_interpolation
        self.interpolate_xyz_encoding = interpolate_xyz_encoding
        kw = dict(dtype=mlp_dtype, device=device, generator=generator)
        tkw = dict(device=device, generator=generator)
        self.register_buffer("aabb", torch.tensor(aabb, dtype=torch.float32,
                                                  device=device), persistent=False)
        if training_timesteps is None:
            training_timesteps = torch.zeros(0)
        self.register_buffer("training_timesteps", torch.as_tensor(
            training_timesteps, dtype=torch.float32, device=device), persistent=False)

        self.xyz_table = nn.Parameter(init_grid_table(static_spec, table_param_dtype, **tkw))
        # geometry features, then the feature head's semantic ones
        self.base_mlp = Sequential64(static_spec.n_output_dims, (base_mlp_layer_width, gf + sf),
                                     **kw)
        if self.has_dynamic:
            if self.fused:
                self.dynflow_spec = dataclasses.replace(
                    dynamic_spec,
                    n_features_per_level=(dynamic_spec.n_features_per_level
                                          + flow_spec.n_features_per_level))
                self.dynflow_table = nn.Parameter(
                    init_grid_table(self.dynflow_spec, table_param_dtype, **tkw))
            else:
                self.dynamic_table = nn.Parameter(
                    init_grid_table(dynamic_spec, table_param_dtype, **tkw))
                if self.has_flow:
                    self.flow_table = nn.Parameter(
                        init_grid_table(flow_spec, table_param_dtype, **tkw))
            self.dynamic_base_mlp = Sequential64(
                dynamic_spec.n_output_dims, (base_mlp_layer_width, gf + sf), **kw)
        if self.has_flow:
            # 3 layers of base width -> 6 (fwd + bwd flow), no final activation
            flow_levels = (dynamic_spec if self.fused else flow_spec).n_levels
            self.flow_mlp = Sequential64(
                flow_levels * flow_spec.n_features_per_level,
                (base_mlp_layer_width, base_mlp_layer_width, 6), **kw)

        if self.use_appearance_embedding:
            n_embeds = num_cams if enable_cam_embedding else num_train_timesteps * num_cams
            self.appearance_embedding = nn.Embedding(
                max(n_embeds, 1), appearance_embedding_dim, device=device)
            torch_embedding_init_(self.appearance_embedding, generator)
        app = appearance_embedding_dim if self.use_appearance_embedding else 0
        dir_dim = sh_output_dim(4) if direction_encoding == "sh" else sinusoidal_output_dim(3)
        self.rgb_head = MLP(dir_dim + app + gf, 3, num_layers=3,
                            hidden_dims=head_mlp_layer_width, skip_connections=(1,), **kw)
        if enable_shadow_head:
            self.shadow_head = Sequential64(gf, (base_mlp_layer_width, 1),
                                            final_sigmoid=True, **kw)
        if enable_sky_head:
            self.sky_head = MLP(dir_dim + app, 3, num_layers=3,
                                hidden_dims=head_mlp_layer_width, skip_connections=(1,), **kw)
        if enable_feature_head:
            fw, fe = feature_mlp_layer_width, feature_embedding_dim
            if enable_sky_head:
                self.dino_sky_head = Sequential64(dir_dim + app, (fw, fw, fe), **kw)
            self.dino_head = Sequential64(sf, (fw, fw, fe), **kw)
            if self.enable_learnable_pe:
                h, w = PE_MAP_HW
                self.learnable_pe_map = nn.Parameter(0.05 * torch.randn(
                    (h, w, fe // 2), device=device, generator=generator))
                self.pe_head = Sequential64(fe // 2, (fe,), **kw)

    # ------------------------------------------------------------------ #
    @property
    def use_appearance_embedding(self) -> bool:
        return self.enable_cam_embedding or self.enable_img_embedding

    @property
    def has_dynamic(self) -> bool:
        return self.dynamic_spec is not None

    @property
    def has_flow(self) -> bool:
        return self.flow_spec is not None

    @property
    def fused(self) -> bool:
        """One fused dynamic+flow grid (else separate dynamic and flow grids,
        or the dynamic grid alone)."""
        return self.fuse_flow_grid and self.has_dynamic and self.has_flow

    def contract_points(self, positions):
        return _contract(positions, self.aabb, self.unbounded)

    def forward_static_hash(self, positions):
        normed = self.contract_points(positions)
        enc = grid_encode(self.xyz_table, normed.contiguous(), self.static_spec,
                          self.table_dtype)
        return self.base_mlp(enc.float()), normed

    def _dynflow_encode(self, normed_positions, normed_timestamps):
        """ONE fused 4D query -> (dynamic enc (..., L*F_d), flow enc (..., L*F_f))."""
        enc = self._encode_4d(self.dynflow_table, self.dynflow_spec, normed_positions,
                              normed_timestamps)
        df = self.dynamic_spec.n_features_per_level
        lanes = enc.reshape(*enc.shape[:-1], self.dynflow_spec.n_levels, -1)
        return lanes[..., :df].flatten(-2), lanes[..., df:].flatten(-2)

    def _encode_4d(self, table, spec, normed_positions, normed_timestamps):
        xyzt = torch.cat([normed_positions, normed_timestamps[..., None]], dim=-1)
        return grid_encode(table, xyzt, spec, self.table_dtype).float()

    def forward_dynamic_hash(self, normed_positions, normed_timestamps):
        """The separate dynamic grid's 4D query + the dynamic base MLP ->
        (features, encoding)."""
        enc = self._encode_4d(self.dynamic_table, self.dynamic_spec, normed_positions,
                              normed_timestamps)
        return self.dynamic_base_mlp(enc), enc

    def forward_flow_hash(self, normed_positions, normed_timestamps, train: bool = True):
        """The flow grid's 4D query + the flow MLP -> (..., 6) = (forward
        flow, backward flow).  At eval (``train`` false) with temporal
        interpolation, the flow is queried at the two training timesteps
        nearest the time of each ray (the first of the last axis, the
        reference's per-ray time; a point batch (N,) takes its first
        point's) and lerped by the offset between them: past the last
        training timestep the offset leaves [0, 1] and extrapolates."""
        if not self._interpolates(train):
            return self.flow_mlp(self._flow_encode(normed_positions, normed_timestamps))
        t_ray = normed_timestamps[..., 0]
        near2 = find_topk_nearby_timesteps(self.training_timesteps, t_ray)
        left, right = near2[..., 0], near2[..., 1]
        denom = right - left
        offset = torch.where(denom.abs() > 1e-8, (t_ray - left) / denom,
                             torch.zeros_like(denom))[..., None, None]
        n = normed_timestamps.shape[-1]
        enc_l = self._flow_encode(normed_positions, left[..., None].expand(*left.shape, n))
        enc_r = self._flow_encode(normed_positions, right[..., None].expand(*right.shape, n))
        if self.interpolate_xyz_encoding:
            return self.flow_mlp(enc_l * (1 - offset) + enc_r * offset)
        return self.flow_mlp(enc_l) * (1 - offset) + self.flow_mlp(enc_r) * offset

    def _interpolates(self, train: bool) -> bool:
        """Whether flow queries interpolate between training timesteps: at
        eval only, with the setting on and training timesteps known."""
        return (not train and self.enable_temporal_interpolation
                and self.training_timesteps.numel() > 0)

    def _flow_encode(self, normed_positions, normed_timestamps):
        if self.fused:
            return self._dynflow_encode(normed_positions, normed_timestamps)[1]
        return self._encode_4d(self.flow_table, self.flow_spec, normed_positions,
                               normed_timestamps)

    def _fused_flow(self, normed_positions, normed_timestamps, flow_enc, train: bool):
        """The flow at points whose fused query gave ``flow_enc``: its flow
        MLP, or at eval with temporal interpolation the interpolated query
        (two more encodes), as the JAX package routes it."""
        if self._interpolates(train):
            return self.forward_flow_hash(normed_positions, normed_timestamps, train)
        return self.flow_mlp(flow_enc)

    # ------------------------------------------------------------------ #
    def _appearance(self, shape_prefix, data: Dict[str, torch.Tensor]):
        """Appearance embedding per (ray, sample); the mean embedding when
        the indices are missing."""
        if not self.use_appearance_embedding:
            return None
        if self.enable_cam_embedding and "cam_idx" in data:
            return embedding_lookup(self.appearance_embedding.weight, data["cam_idx"])
        if self.enable_img_embedding and "img_idx" in data:
            return embedding_lookup(self.appearance_embedding.weight, data["img_idx"])
        mean = self.appearance_embedding.weight.mean(dim=0)
        return mean.expand(*shape_prefix, self.appearance_embedding_dim)

    def _encode_dirs(self, directions01):
        if self.direction_encoding == "sh":
            return sh_encode(directions01, degree=4)
        return sinusoidal_encode(directions01, min_deg=0, max_deg=4)

    def query_rgb(self, directions, geo_feats, dynamic_geo_feats=None, data=None):
        data = data or {}
        directions = (directions + 1.0) / 2.0
        h = self._encode_dirs(directions)
        app = self._appearance(directions.shape[:-1], data)
        if app is not None:
            h = torch.cat([h, app], dim=-1)
        results = {"rgb": torch.sigmoid(self.rgb_head(torch.cat([h, geo_feats], -1)))}
        if dynamic_geo_feats is not None:
            results["dynamic_rgb"] = torch.sigmoid(
                self.rgb_head(torch.cat([h, dynamic_geo_feats], -1)))
        return results

    def query_sky(self, directions_per_ray, data=None):
        """Sky color from RAW per-ray directions (no (d+1)/2 remap, as in the
        reference; spherical harmonics then map them to 2d - 1, outside
        [-1, 1], as the reference does too)."""
        dd = self._encode_dirs(directions_per_ray)
        app = self._appearance(directions_per_ray.shape[:-1], data or {})
        if app is not None:
            dd = torch.cat([dd, app], dim=-1)
        results = {"rgb_sky": torch.sigmoid(self.sky_head(dd))}
        if self.enable_feature_head:
            results["dino_sky_feat"] = self.dino_sky_head(dd)
        return results

    def temporal_aggregation(self, positions, normed_positions, normed_timestamps,
                             forward_flow, backward_flow, cur_feats=None, noise=None,
                             train: bool = False):
        """Flow-warped feature aggregation (Eq. 8).  ``noise`` (R, S, 1) is
        the training-time uniform draw that scales the flow; None is the
        eval's 1.

        Fused, ``cur_feats`` (the current-time dynamic features) come from
        the caller's fused query and the two warped points are ONE batched
        2N fused encode.  Unfused (``cur_feats`` None), the current, +warp
        and -warp dynamic queries are ONE batched 3N encode and the two
        warped flow queries ONE 2N encode."""
        shape = (*forward_flow.shape[:-1], 1)
        if noise is None:
            noise = torch.ones(shape, dtype=forward_flow.dtype, device=forward_flow.device)
        elif tuple(noise.shape) != shape:
            raise ValueError(f"aggregation noise {tuple(noise.shape)} != {shape}")
        k = self.temporal_agg_topk
        if self.fused and positions.ndim == 3 and 0 < k < positions.shape[1]:
            return self._topk_aggregation(positions, normed_timestamps, forward_flow,
                                          backward_flow, cur_feats, noise, k, train)
        fwd_pos = self.contract_points(positions + forward_flow * noise)
        bwd_pos = self.contract_points(positions + backward_flow * noise)
        noise_t = noise[..., 0]
        fwd_time = (normed_timestamps + self.time_diff * noise_t).clamp(0.0, 1.0)
        bwd_time = (normed_timestamps - self.time_diff * noise_t).clamp(0.0, 1.0)
        pos2, t2 = torch.stack([fwd_pos, bwd_pos]), torch.stack([fwd_time, bwd_time])
        if self.fused:
            dyn2, flow2 = self._dynflow_encode(pos2, t2)
            fwd_feats, bwd_feats = self.dynamic_base_mlp(dyn2).unbind(0)
            pred2 = self._fused_flow(pos2, t2, flow2, train)
        else:
            feats3, _ = self.forward_dynamic_hash(
                torch.stack([normed_positions, fwd_pos, bwd_pos]),
                torch.stack([normed_timestamps, fwd_time, bwd_time]))
            cur_feats, fwd_feats, bwd_feats = feats3.unbind(0)
            pred2 = self.forward_flow_hash(pos2, t2, train)
        aggregated = (cur_feats + 0.5 * fwd_feats + 0.5 * bwd_feats) / 2.0
        return {
            "dynamic_feats": aggregated,
            "forward_pred_backward_flow": pred2[0][..., 3:],
            "backward_pred_forward_flow": pred2[1][..., :3],
        }

    def _topk_aggregation(self, positions, normed_timestamps, forward_flow,
                          backward_flow, cur_feats, noise, k: int, train: bool):
        """Aggregation on the K most dynamic samples per ray (by current-time
        dynamic density); the others keep their current-time features, and
        ``agg_mask`` marks the selected samples.  Selection is a stable
        descending sort, which breaks ties (e.g. the identical encodings of
        every sample outside the unit cube) in index order as
        ``jax.lax.top_k`` does; ``torch.topk`` does not."""
        cur_density = density_activation(cur_feats[..., 0])  # (R, S)
        idx = torch.sort(cur_density, dim=-1, descending=True, stable=True)[1][:, :k]

        def sel(x):  # (R, S, ...) -> (R, K, ...)
            if x.ndim == 2:
                return torch.gather(x, 1, idx)
            return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

        pos_k, t_k, noise_k = sel(positions), sel(normed_timestamps), sel(noise)
        fwd_pos = self.contract_points(pos_k + sel(forward_flow) * noise_k)
        bwd_pos = self.contract_points(pos_k + sel(backward_flow) * noise_k)
        nt = noise_k[..., 0]
        fwd_time = (t_k + self.time_diff * nt).clamp(0.0, 1.0)
        bwd_time = (t_k - self.time_diff * nt).clamp(0.0, 1.0)
        pos2, t2 = torch.stack([fwd_pos, bwd_pos]), torch.stack([fwd_time, bwd_time])
        dyn2, flow2 = self._dynflow_encode(pos2, t2)
        feats2 = self.dynamic_base_mlp(dyn2)  # (2, R, K, gf)
        pred2 = self._fused_flow(pos2, t2, flow2, train)  # (2, R, K, 6)

        def unsel(vals_k):  # (R, K, F) -> (R, S, F), zeros off-mask
            out = vals_k.new_zeros((*positions.shape[:2], vals_k.shape[-1]))
            return out.scatter(1, idx[..., None].expand(-1, -1, vals_k.shape[-1]), vals_k)

        mask = torch.zeros_like(cur_density).scatter(1, idx, 1.0)
        agg_k = (sel(cur_feats) + 0.5 * feats2[0] + 0.5 * feats2[1]) / 2.0
        aggregated = cur_feats * (1.0 - mask)[..., None] + unsel(agg_k)
        return {
            "dynamic_feats": aggregated,
            "forward_pred_backward_flow": unsel(pred2[0][..., 3:]),
            "backward_pred_forward_flow": unsel(pred2[1][..., :3]),
            "agg_mask": mask,
        }

    def _flow_and_aggregation(self, positions, normed_positions, t, agg_noise, results,
                              train: bool):
        """The flow query and the temporal aggregation: puts the flows (and
        the aggregation's outputs) into ``results`` and returns the
        aggregated dynamic features."""
        if self.fused:
            dyn_enc, flow_enc = self._dynflow_encode(normed_positions, t)
            cur_feats = self.dynamic_base_mlp(dyn_enc)
            flow = self._fused_flow(normed_positions, t, flow_enc, train)
        else:
            # the current-time dynamic query is batched inside
            # temporal_aggregation with the two warped ones
            cur_feats = None
            flow = self.forward_flow_hash(normed_positions, t, train)
        forward_flow, backward_flow = flow[..., :3], flow[..., 3:]
        results["forward_flow"] = forward_flow
        results["backward_flow"] = backward_flow
        agg = self.temporal_aggregation(positions, normed_positions, t, forward_flow,
                                        backward_flow, cur_feats, agg_noise, train)
        dynamic_feats = agg.pop("dynamic_feats")
        results.update(agg)
        return dynamic_feats

    # ------------------------------------------------------------------ #
    def query_flow(self, positions: torch.Tensor, normed_timestamps: torch.Tensor,
                   train: bool = False) -> Dict[str, torch.Tensor]:
        """Point query of the flow field and the dynamic density: positions
        (N, 3), timestamps (N,).  Fused, one 4D query gives both (the JAX
        package makes two of the same points); with temporal interpolation
        at eval the flow comes from the interpolated queries and the
        density stays at the exact timestamps."""
        normed = self.contract_points(positions)
        if self.fused:
            dyn_enc, flow_enc = self._dynflow_encode(normed, normed_timestamps)
            dynamic_feats = self.dynamic_base_mlp(dyn_enc)
            flow = self._fused_flow(normed, normed_timestamps, flow_enc, train)
        else:
            flow = self.forward_flow_hash(normed, normed_timestamps, train)
            dynamic_feats, _ = self.forward_dynamic_hash(normed, normed_timestamps)
        return {"forward_flow": flow[..., :3], "backward_flow": flow[..., 3:],
                "dynamic_density": density_activation(dynamic_feats[..., 0])}

    def query_attributes(self, positions: torch.Tensor,
                         normed_timestamps: Optional[torch.Tensor] = None,
                         train: bool = False) -> Dict[str, torch.Tensor]:
        """Point query of the densities (and, with the flow branch, the flows)
        of positions (N, 3) at timestamps (N,), the eval's field query
        without directions: aggregated dynamic features, as the renders
        shade them.  Without timestamps, the static density alone.  With
        the feature head, ``dino_feat``: with the dynamic branch the
        density-weighted mix of ``static_dino_feat`` and
        ``dynamic_dino_feat``."""
        results: Dict[str, torch.Tensor] = {}
        dynamic = normed_timestamps is not None and self.has_dynamic
        data = {"normed_timestamps": normed_timestamps} if dynamic else {}
        _, sem, _, dyn_sem = self._features(positions, data, None, results, train)
        keys = (("forward_flow", "backward_flow", "density", "static_density",
                 "dynamic_density") if dynamic else ("density",))
        out = {k: results[k] for k in keys if k in results}
        if self.enable_feature_head:
            dino = self.dino_head(sem)
            if dyn_sem is None:
                out["dino_feat"] = dino
            else:
                dyn_dino = self.dino_head(dyn_sem)
                out["static_dino_feat"], out["dynamic_dino_feat"] = dino, dyn_dino
                out["dino_feat"] = (out["static_density"][..., None] * dino
                                    + out["dynamic_density"][..., None] * dyn_dino
                                    ) / (out["density"][..., None] + 1e-6)
        return out

    def _features(self, positions, data, agg_noise, results, train: bool):
        """The static and (with timestamps) dynamic grid queries and base
        MLPs: puts the densities (and the flows and the aggregation's
        outputs) into ``results``; returns (geometry, semantic, dynamic
        geometry, dynamic semantic features), the dynamic ones None
        without the dynamic branch."""
        gf = self.geometry_feature_dim
        encoded, normed_positions = self.forward_static_hash(positions)
        geo_feats, semantic_feats = encoded[..., :gf], encoded[..., gf:]
        static_density = density_activation(geo_feats[..., 0])
        if not (self.has_dynamic and "normed_timestamps" in data):
            results["density"] = static_density
            results["static_density"] = static_density
            return geo_feats, semantic_feats, None, None
        t = data["normed_timestamps"]
        if self.has_flow:
            dynamic_feats = self._flow_and_aggregation(positions, normed_positions, t,
                                                       agg_noise, results, train)
        else:
            # the dynamic grid alone: no flow, no aggregation
            dynamic_feats, _ = self.forward_dynamic_hash(normed_positions, t)
        dynamic_geo_feats = dynamic_feats[..., :gf]
        dynamic_density = density_activation(dynamic_geo_feats[..., 0])
        results.update(density=static_density + dynamic_density, static_density=static_density,
                       dynamic_density=dynamic_density)
        return geo_feats, semantic_feats, dynamic_geo_feats, dynamic_feats[..., gf:]

    def forward(self, positions: torch.Tensor, directions: Optional[torch.Tensor] = None,
                data: Optional[Dict[str, torch.Tensor]] = None,
                return_density_only: bool = False,
                agg_noise: Optional[torch.Tensor] = None,
                train: bool = False) -> Dict[str, torch.Tensor]:
        """One field query; positions and directions are (R, S, 3).
        ``agg_noise`` (R, S, 1): training-time aggregation noise (None at
        eval; unused without the flow branch); ``return_density_only``:
        densities (and flow) only; ``train``: a training query, which never
        interpolates the flow between training timesteps.  ``data["pixel_coords"]`` (R, 2), the
        rays' (y/H, x/W), places the learnable PE map's sample."""
        data = data or {}
        results: Dict[str, torch.Tensor] = {}
        geo_feats, semantic_feats, dynamic_geo_feats, dynamic_semantic_feats = self._features(
            positions, data, agg_noise, results, train)
        if return_density_only:
            return results
        if directions is not None:
            rgb = self.query_rgb(directions, geo_feats, dynamic_geo_feats, data=data)
            if dynamic_geo_feats is None:
                results["rgb"] = rgb["rgb"]
            else:
                results["static_rgb"] = rgb["rgb"]
                results["dynamic_rgb"] = rgb["dynamic_rgb"]
        if self.enable_shadow_head and dynamic_geo_feats is not None:
            results["shadow_ratio"] = self.shadow_head(dynamic_geo_feats)

        if self.enable_feature_head:
            if self.enable_learnable_pe and "pixel_coords" in data:
                # pixel_coords is (y/H, x/W) and is fed to the sampler as-is,
                # as the reference does: coordinate 0 indexes the map's width
                # axis and coordinate 1 its height axis
                pc = data["pixel_coords"] * 2.0 - 1.0
                pe = grid_sample_2d(self.learnable_pe_map, pc[..., 0], pc[..., 1])
                results["dino_pe"] = self.pe_head(pe)
            dino_feats = self.dino_head(semantic_feats)
            if dynamic_semantic_feats is None:
                results["dino_feat"] = dino_feats
            else:
                results["static_dino_feat"] = dino_feats
                results["dynamic_dino_feat"] = self.dino_head(dynamic_semantic_feats)

        if self.enable_sky_head and directions is not None:
            per_ray_data = {k: v[:, 0] for k, v in data.items()
                            if v.ndim >= 2 and k != "pixel_coords"}
            results.update(self.query_sky(directions[:, 0], data=per_ray_data))
        return results
