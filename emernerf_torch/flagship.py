"""Flagship model setup (port of ``emernerf_tpu/flagship.py``): the full
EmerNeRF configuration (static + dynamic + flow fields, sky + shadow heads,
reference-scale grids) on the synthetic dynamic scene.

Four profiles: the default (``configs/default_config.yaml``: brick grids,
top-K sample pruning and aggregation); ``DYNAMIC``, the stock dynamic
decomposition without flow (``configs/default_dynamic.yaml``: static and
dynamic grids and the shadow head, no flow grid, no aggregation); and the
work per ray of the original CUDA EmerNeRF (``configs/reference_semantics.yaml``:
every sample shaded and flow-warped, separate dynamic and flow tables of
unpaired 4D rows) on brick grids, ``REFERENCE_BRICK``, or with the exact
tiny-cuda-nn hash grid, ``REFERENCE_HASH``.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import torch

from emernerf_torch import resolve_device
from emernerf_torch.builders import (
    build_dataset_from_cfg,
    build_model_from_cfg,
    build_propnets_from_cfg,
    build_train_step_config,
    make_grid_spec,
    cfg_perf,
    cfg_time_pair,
)
from emernerf_torch.config import load_config

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONFIG = os.path.join(_REPO_ROOT, "configs", "default_config.yaml")


class Profile(NamedTuple):
    """A config file and a dotlist merged over the defaults."""

    config_file: Optional[str]
    overrides: Sequence[str]


_CONFIGS = os.path.join(_REPO_ROOT, "configs")
DEFAULT_PROFILE = Profile(None, ())
# the flagship dotlist turns the flow branch on: the override turns it off
DYNAMIC = Profile(os.path.join(_CONFIGS, "default_dynamic.yaml"),
                  ("nerf.model.head.enable_flow_branch=false",))
REFERENCE_BRICK = Profile(os.path.join(_CONFIGS, "reference_semantics.yaml"), ())
REFERENCE_HASH = Profile(os.path.join(_CONFIGS, "reference_semantics.yaml"),
                         ("nerf.model.grid_backend=hash",))

_FLAGSHIP_DOTLIST = (
    "data.dataset=synthetic",
    "data.synthetic.dynamic=true",
    "data.pixel_source.num_cams=1",
    "nerf.model.head.enable_dynamic_branch=true",
    "nerf.model.head.enable_shadow_head=true",
    "nerf.model.head.enable_flow_branch=true",
)
# tiny: small grids and sample counts for CPU runs, every branch kept on
_TINY_DOTLIST = (
    "data.ray_batch_size=64",
    "data.synthetic.num_frames=3",
    "data.synthetic.image_height=16",
    "data.synthetic.image_width=24",
    "nerf.model.xyz_encoder.n_levels=4",
    "nerf.model.xyz_encoder.log2_hashmap_size=10",
    "nerf.model.xyz_encoder.max_resolution=64",
    "nerf.model.dynamic_xyz_encoder.n_levels=4",
    "nerf.model.dynamic_xyz_encoder.log2_hashmap_size=10",
    "nerf.model.dynamic_xyz_encoder.max_resolution=64",
    "nerf.propnet.num_samples_per_prop=[8,4]",
    "nerf.propnet.fine_level_skip=0",
    "nerf.propnet.xyz_encoder.n_levels_per_prop=[2,2]",
    "nerf.propnet.xyz_encoder.max_resolution_per_prop=[32,64]",
    "nerf.propnet.xyz_encoder.lgo2_hashmap_size_per_prop=[10,10]",
    "nerf.sampling.num_samples=4",
    "nerf.model.neck.geometry_feature_dim=16",
    "nerf.model.neck.base_mlp_layer_width=16",
    "nerf.model.head.head_mlp_layer_width=16",
    "nerf.model.head.temporal_agg_topk=2",
)


def flagship_config(tiny: bool = False, overrides=(), profile: Profile = DEFAULT_PROFILE):
    """Full-feature config (dynamic + flow, unless the profile turns the flow
    off) of ``profile``; ``tiny=True`` shrinks grids and sample counts while
    keeping every branch of the profile enabled.
    Merged as the CLI merges: defaults <- the profile's config file <- the
    flagship dotlist, the profile's overrides and ``overrides``."""
    dot = (list(_FLAGSHIP_DOTLIST) + (list(_TINY_DOTLIST) if tiny else [])
           + list(profile.overrides) + list(overrides))
    return load_config(DEFAULT_CONFIG, profile.config_file, dot)


def tiny_flow_spec(backend: str, time_pair: bool = True, perf=None):
    """The tiny flagship's flow grid, of ``backend`` and row pairing, with
    the signature of ``builders.flow_spec`` (the reference fixes the flow
    encoder's structure, so no config names it: a tiny CLI run puts this in
    ``builders.flow_spec``'s place)."""
    return make_grid_spec(backend, 4, 4, 8, 64, 10, 2, time_pair=time_pair, perf=perf)


def flagship_flow_spec(cfg, tiny: bool = False):
    """The flow grid's spec for ``cfg``: the reference's fixed one (None), or
    (tiny) a small one of the config's backend and row pairing that keeps
    the flow branch."""
    if not tiny:
        return None
    return tiny_flow_spec(cfg.nerf.model.get("grid_backend", "brick"), cfg_time_pair(cfg),
                          cfg_perf(cfg))


def build_flagship(tiny: bool = False, overrides=(), *, profile: Profile = DEFAULT_PROFILE,
                   device="cuda", seed: int = 0):
    """Returns (cfg, dataset, model, prop_models, step_cfg) of ``profile``,
    initialized on ``device`` (the card unless the caller asks for the CPU)
    from ``seed``."""
    dev = resolve_device(device)
    cfg = flagship_config(tiny, overrides, profile)
    dataset = build_dataset_from_cfg(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    flow = flagship_flow_spec(cfg, tiny)
    model = build_model_from_cfg(cfg, dataset, device=dev, generator=gen, flow=flow)
    prop_models = build_propnets_from_cfg(cfg, dataset, device=dev, generator=gen)
    return cfg, dataset, model, prop_models, build_train_step_config(cfg, dataset)
