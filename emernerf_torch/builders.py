"""Factories: config + dataset -> the port's models (port of ``emernerf_tpu/builders.py``).

Takes the same config schema, with ``grid_backend`` ``brick`` (the default
profile) or ``hash`` (the exact tiny-cuda-nn grid, the reference-exact
profile with ``configs/reference_semantics.yaml``).  The dynamic and flow
grids are fused by default on the brick backend and separate on the hash
backend, as in the JAX package; ``nerf.model.fuse_flow_grid`` overrides
that.  A knob that the port does not run raises instead of being ignored:
``grid_backend=mx`` (rejected on quality), ``nerf.propnet.fine_level_skip
> 0``, a non-default ``nerf.model.perf.*``
formulation knob (``perf.time_pair=false`` is taken: unpaired 4D brick
rows, two gathers per (point, level), as the reference-semantics profile
asks; the hash grid's rows are never paired), the flow branch without the
dynamic branch and ``optim.fused_lidar_branch`` (left behind).  Taken as
in the JAX package: spherical-harmonics directions
(``nerf.model.head.direction_encoding=sh``), the eval-time temporal
interpolation of the flow (``enable_temporal_interpolation``, anchored at
the dataset's training timesteps) and ``optim.remat`` (the field query
recomputed in the backward).  Datasets: ``synthetic``, ``waymo`` and
``nuscenes``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from emernerf_torch.config import ConfigNode
from emernerf_torch.data import synthetic
from emernerf_torch.data.dataset import SceneDataset
from emernerf_torch.data.nuscenes import load_nuscenes_dataset
from emernerf_torch.data.waymo import load_waymo_dataset
from emernerf_torch.models.fields import DensityField, RadianceField
from emernerf_torch.ops.brickgrid import BrickGridSpec
from emernerf_torch.ops.hashgrid import HashGridSpec
from emernerf_torch.train.step import TrainStepConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_BACKENDS = ("brick", "hash")
# nerf.model.perf.* at their defaults: TPU formulation choices that have no
# meaning in the port (its kernels have one formulation each)
_PERF_DEFAULTS = {
    "scatter_mode": "wide", "reduce_mode": "unroll", "posgrad_mode": "fwd",
    "gather_mode": "2d", "onehot_budget": 1 << 19, "grad_subsample": 1,
}


def _grid_backend(cfg: ConfigNode) -> str:
    return cfg.nerf.model.get("grid_backend", "brick")


def _perf(cfg: ConfigNode):
    return cfg.nerf.model.get("perf", None) or {}


def cfg_time_pair(cfg: ConfigNode) -> bool:
    """Whether the config's 4D brick rows pair their two time corners
    (``nerf.model.perf.time_pair``, on by default)."""
    return bool(_perf(cfg).get("time_pair", True))


def validate_cfg(cfg: ConfigNode) -> None:
    """Raise on every configured knob the port does not run."""
    backend = _grid_backend(cfg)
    if backend not in _BACKENDS:
        raise NotImplementedError(
            f"nerf.model.grid_backend={backend!r}: only {_BACKENDS} are ported")
    for k, v in _perf(cfg).items():
        if k == "time_pair":
            continue  # either layout: K1 reads paired and unpaired 4D rows
        if k not in _PERF_DEFAULTS or v != _PERF_DEFAULTS[k]:
            raise NotImplementedError(
                f"nerf.model.perf.{k}={v!r}: only the default formulation is ported")
    skip = int(cfg.nerf.propnet.get("fine_level_skip", 0))
    if skip > 0 and backend != "brick":
        raise ValueError(
            f"nerf.propnet.fine_level_skip={skip} requires grid_backend=brick (got "
            f"{backend!r}): the hash/mx specs have no coarse-view support")
    if skip > 0:
        raise NotImplementedError("nerf.propnet.fine_level_skip>0 is not ported")
    head = cfg.nerf.model.head
    if head.enable_flow_branch and not head.enable_dynamic_branch:
        # the fields use the flow only inside the dynamic branch
        raise NotImplementedError("the flow branch needs the dynamic branch")


def make_grid_spec(backend: str, n_input_dims: int, n_levels: int, base_resolution: int,
                   max_resolution: int, log2_hashmap_size: int, n_features_per_level: int,
                   time_pair: bool = True):
    """Grid spec for the configured backend.

    "brick": cell capacity of the configured hash table.  F=1 3D grids
    (proposal nets) use 4^3-cell bricks (125-corner rows, cell capacity 64
    per row); others 2^3-cell bricks.  4D rows store both time corners
    unless ``time_pair`` is false (``nerf.model.perf.time_pair``).
    "hash": the exact tiny-cuda-nn layout."""
    if backend == "hash":
        return HashGridSpec(
            n_input_dims=n_input_dims, n_levels=n_levels, base_resolution=base_resolution,
            max_resolution=max_resolution, log2_hashmap_size=log2_hashmap_size,
            n_features_per_level=n_features_per_level)
    if backend != "brick":
        raise ValueError(f"Unknown grid backend: {backend}")
    bs = 2 if n_features_per_level == 1 and n_input_dims == 3 else 1
    return BrickGridSpec(
        n_input_dims=n_input_dims,
        n_levels=n_levels,
        base_resolution=base_resolution,
        max_resolution=max_resolution,
        log2_bricks=max(log2_hashmap_size - 3 * bs, 4),
        n_features_per_level=n_features_per_level,
        log2_brick_size=bs,
        time_pair=n_input_dims == 4 and time_pair,
    )


def _enc_spec(enc_cfg: ConfigNode, backend: str, time_pair: bool = True):
    return make_grid_spec(
        backend, n_input_dims=enc_cfg.n_input_dims, n_levels=enc_cfg.n_levels,
        base_resolution=enc_cfg.base_resolution,
        max_resolution=enc_cfg.max_resolution,
        log2_hashmap_size=enc_cfg.log2_hashmap_size,
        n_features_per_level=enc_cfg.n_features_per_level,
        time_pair=time_pair,
    )


def flow_spec(backend: str, time_pair: bool = True):
    """The flow encoder's structure is fixed in the reference; ``time_pair``
    picks paired or unpaired 4D rows."""
    return make_grid_spec(backend, n_input_dims=4, n_levels=10, base_resolution=16,
                          max_resolution=4096, log2_hashmap_size=18,
                          n_features_per_level=4, time_pair=time_pair)


def _dtype(cfg: ConfigNode, key: str):
    return _DTYPES[cfg.nerf.model.get(key, "float32")]


def build_model_from_cfg(cfg: ConfigNode, dataset: SceneDataset, *,
                         device=None, generator=None, flow=None) -> RadianceField:
    """The radiance field for ``cfg`` (``flow`` overrides the flow spec)."""
    validate_cfg(cfg)
    model_cfg = cfg.nerf.model
    head = model_cfg.head
    enable_cam, enable_img = head.enable_cam_embedding, head.enable_img_embedding
    if dataset.has_test_split and enable_img:
        # per-image embeddings can't generalize to held-out images
        enable_cam, enable_img = True, False
    # the base MLPs carry semantic features only for the feature head, whose
    # output width is the dataset's feature maps' where it has them
    enable_feature = head.enable_feature_head
    semantic_dim = model_cfg.neck.semantic_feature_dim if enable_feature else 0
    feature_dim = head.feature_embedding_dim
    if enable_feature and dataset.features is not None:
        feature_dim = int(dataset.features.shape[-1])
    backend = _grid_backend(cfg)
    pair = cfg_time_pair(cfg)
    dynamic = (_enc_spec(model_cfg.dynamic_xyz_encoder, backend, pair)
               if head.enable_dynamic_branch else None)
    flow = (flow or flow_spec(backend, pair)) if head.enable_flow_branch else None
    # fused dynamic+flow grid by default on the brick backend; the hash
    # backend keeps the reference's separate grids
    fuse = (bool(model_cfg.get("fuse_flow_grid", backend == "brick"))
            and dynamic is not None and flow is not None)
    return RadianceField(
        static_spec=_enc_spec(model_cfg.xyz_encoder, backend, pair),
        dynamic_spec=dynamic,
        flow_spec=flow,
        fuse_flow_grid=fuse,
        temporal_agg_topk=int(head.get("temporal_agg_topk", 0)) if fuse else 0,
        aabb=tuple(float(v) for v in dataset.aabb),
        unbounded=cfg.nerf.unbounded,
        geometry_feature_dim=model_cfg.neck.geometry_feature_dim,
        base_mlp_layer_width=model_cfg.neck.base_mlp_layer_width,
        head_mlp_layer_width=head.head_mlp_layer_width,
        enable_cam_embedding=enable_cam,
        enable_img_embedding=enable_img,
        num_cams=dataset.num_cams,
        appearance_embedding_dim=head.appearance_embedding_dim,
        enable_sky_head=head.enable_sky_head,
        enable_shadow_head=head.enable_shadow_head,
        semantic_feature_dim=semantic_dim,
        feature_mlp_layer_width=head.feature_mlp_layer_width,
        feature_embedding_dim=feature_dim,
        enable_feature_head=enable_feature,
        enable_learnable_pe=head.enable_learnable_pe,
        num_train_timesteps=dataset.num_img_timesteps,
        time_diff=dataset.time_diff,
        table_dtype=_dtype(cfg, "table_dtype"),
        table_param_dtype=_dtype(cfg, "table_param_dtype"),
        mlp_dtype=_dtype(cfg, "mlp_dtype"),
        direction_encoding=head.get("direction_encoding", "sinusoidal"),
        enable_temporal_interpolation=bool(head.get("enable_temporal_interpolation", False)),
        interpolate_xyz_encoding=bool(head.get("interpolate_xyz_encoding", True)),
        training_timesteps=torch.as_tensor(dataset.unique_normalized_training_timestamps,
                                           dtype=torch.float32, device=device),
        device=device,
        generator=generator,
    )


def build_propnets_from_cfg(cfg: ConfigNode, dataset: SceneDataset, *,
                            device=None, generator=None) -> List[DensityField]:
    """The proposal density fields, one per proposal level."""
    validate_cfg(cfg)
    pcfg = cfg.nerf.propnet
    enc = pcfg.xyz_encoder
    nets = []
    for i in range(len(pcfg.num_samples_per_prop)):
        spec = make_grid_spec(
            _grid_backend(cfg),
            n_input_dims=enc.n_input_dims,
            n_levels=enc.n_levels_per_prop[i],
            base_resolution=enc.base_resolutions_per_prop[i],
            max_resolution=enc.max_resolution_per_prop[i],
            log2_hashmap_size=enc.lgo2_hashmap_size_per_prop[i],
            n_features_per_level=enc.n_features_per_level,
        )
        nets.append(DensityField(
            spec=spec,
            aabb=tuple(float(v) for v in dataset.aabb),
            unbounded=cfg.nerf.unbounded,
            table_dtype=_dtype(cfg, "table_dtype"),
            table_param_dtype=_dtype(cfg, "table_param_dtype"),
            mlp_dtype=_dtype(cfg, "mlp_dtype"),
            device=device,
            generator=generator,
        ))
    return nets


def build_train_step_config(cfg: ConfigNode, dataset: SceneDataset) -> TrainStepConfig:
    """The train step's static settings, as the reference derives them."""
    validate_cfg(cfg)
    if cfg.optim.get("fused_lidar_branch", False):
        raise NotImplementedError("optim.fused_lidar_branch is left behind: the port "
                                  "runs the reference's two-pass step")
    sup = cfg.supervision
    head = cfg.nerf.model.head
    has_lidar = (dataset.lidar is not None and cfg.data.lidar_source.load_lidar
                 and sup.depth.enable)
    lidar_prop = cfg.nerf.propnet.get("lidar_num_samples_per_prop", None)
    if lidar_prop and len(lidar_prop) != len(cfg.nerf.propnet.num_samples_per_prop):
        raise ValueError("nerf.propnet.lidar_num_samples_per_prop must have one entry "
                         "per proposal model")
    los = sup.depth.line_of_sight
    return TrainStepConfig(
        num_samples=cfg.nerf.sampling.num_samples,
        prop_samples=tuple(cfg.nerf.propnet.num_samples_per_prop),
        lidar_prop_samples=tuple(int(v) for v in lidar_prop) if lidar_prop else None,
        near_plane=cfg.nerf.propnet.near_plane,
        far_plane=cfg.nerf.propnet.far_plane,
        sampling_type=cfg.nerf.propnet.sampling_type,
        sample_topk=int(cfg.nerf.sampling.get("sample_topk", 0)),
        sample_topk_temp=float(cfg.nerf.sampling.get("sample_topk_temp", 0.0)),
        lidar_sample_topk=int(cfg.nerf.sampling.get("lidar_sample_topk", -1)),
        lidar_topk_until=float(cfg.nerf.sampling.get("lidar_topk_until", 1.0)),
        enable_anti_aliasing=cfg.nerf.propnet.enable_anti_aliasing_level_loss,
        pulse_widths=tuple(cfg.nerf.propnet.anti_aliasing_pulse_width),
        rgb_loss_type=sup.rgb.loss_type,
        rgb_coef=sup.rgb.loss_coef,
        use_sky_loss=bool(cfg.data.pixel_source.load_sky_mask and head.enable_sky_head
                          and dataset.sky_masks is not None),
        sky_loss_type=sup.sky.loss_type,
        sky_coef=sup.sky.loss_coef,
        use_feature_loss=bool(cfg.data.pixel_source.load_features and head.enable_feature_head
                              and dataset.features is not None),
        feature_loss_type=sup.feature.loss_type,
        feature_coef=sup.feature.loss_coef,
        use_dynamic_reg=head.enable_dynamic_branch,
        dynamic_loss_type=sup.dynamic.loss_type,
        dynamic_coef=sup.dynamic.loss_coef,
        entropy_skewness=sup.dynamic.entropy_loss_skewness,
        use_shadow_loss=head.enable_shadow_head,
        shadow_loss_type=sup.shadow.loss_type,
        shadow_coef=sup.shadow.loss_coef,
        has_flow=head.enable_flow_branch,
        has_lidar=has_lidar,
        depth_loss_type=sup.depth.loss_type,
        depth_coef=sup.depth.loss_coef,
        los_enable=los.enable,
        los_coef=los.loss_coef,
        los_start_iter=los.start_iter,
        los_start_epsilon=los.start_epsilon,
        los_end_epsilon=los.end_epsilon,
        los_decay_steps=los.decay_steps,
        los_decay_rate=los.decay_rate,
        lr=cfg.optim.lr,
        weight_decay=float(cfg.optim.weight_decay),
        num_iters=cfg.optim.num_iters,
        remat=bool(cfg.optim.get("remat", False)),
    )


def build_dataset_from_cfg(cfg: ConfigNode) -> SceneDataset:
    """The synthetic scene, a preprocessed Waymo scene or a nuScenes scene."""
    name = cfg.data.dataset
    if name == "waymo":
        return load_waymo_dataset(cfg)
    if name == "nuscenes":
        return load_nuscenes_dataset(cfg)
    if name != "synthetic":
        raise ValueError(f"Unknown dataset: {name}")
    syn = cfg.data.synthetic
    s = synthetic.make_synthetic_scene(
        num_frames=syn.num_frames,
        num_cams=cfg.data.pixel_source.num_cams,
        hw=(syn.image_height, syn.image_width),
        dynamic=syn.dynamic,
    )
    lidar = None
    if cfg.data.lidar_source.load_lidar:
        frame_idx = np.round(
            s["lidar_normed_timestamps"] * (s["num_frames"] - 1)).astype(np.int64)
        lidar = dict(origins=s["lidar_origins"], viewdirs=s["lidar_viewdirs"],
                     ranges=s["lidar_ranges"], frame_idx=frame_idx, flows=s["lidar_flows"],
                     flow_classes=s["lidar_flow_classes"], ground=s["lidar_ground"])
    return SceneDataset(
        images=s["images"],
        c2w=s["c2w"],
        intrinsics=s["intrinsics"],
        frame_idx=np.repeat(np.arange(s["num_frames"]), s["num_cams"]),
        cam_ids=s["cam_ids"],
        sky_masks=s["sky_masks"] if cfg.data.pixel_source.load_sky_mask else None,
        dynamic_masks=(s["dynamic_masks"]
                       if cfg.data.pixel_source.load_dynamic_mask else None),
        lidar=lidar,
        aabb=s["aabb"],
        test_image_stride=cfg.data.pixel_source.test_image_stride,
        buffer_downscale=cfg.data.pixel_source.sampler.buffer_downscale,
        buffer_ratio=cfg.data.pixel_source.sampler.buffer_ratio,
    )
