"""Hierarchical configuration with YAML files + dotlist overrides (the
port's own copy of ``emernerf_tpu/config.py``; the two must agree, and
``tests/test_torch_imports.py`` holds them to it).

Functional replacement for the original EmerNeRF's OmegaConf usage
(its train_emernerf.py:123-133): a default YAML schema is merged
with a user YAML and a CLI dotlist (``a.b.c=value``).  Only the small subset
of OmegaConf semantics the reference relies on is implemented — attribute
access, deep merge, dotlist parsing with YAML-typed values, and YAML dump.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterable, List, Optional

import yaml


class ConfigNode(dict):
    """A dict with attribute access and deep merge, nested automatically."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    # -- item/attr access -------------------------------------------------
    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, dict) and not isinstance(value, ConfigNode):
            value = ConfigNode(value)
        super().__setitem__(key, value)

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(f"Config has no key {key!r}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    # -- operations --------------------------------------------------------
    def merge_(self, other: Dict[str, Any]) -> "ConfigNode":
        """Deep-merge ``other`` into self (other wins). Returns self."""
        for k, v in other.items():
            if (
                k in self
                and isinstance(self[k], ConfigNode)
                and isinstance(v, dict)
            ):
                self[k].merge_(v)
            else:
                self[k] = copy.deepcopy(v)
        return self

    def set_dotted(self, dotted_key: str, value: Any) -> None:
        node = self
        parts = dotted_key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], ConfigNode):
                node[p] = ConfigNode()
            node = node[p]
        node[parts[-1]] = value

    def get_dotted(self, dotted_key: str, default: Any = None) -> Any:
        node: Any = self
        for p in dotted_key.split("."):
            if not isinstance(node, dict) or p not in node:
                return default
            node = node[p]
        return node

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return out

    def to_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_yaml())

    def copy(self) -> "ConfigNode":  # type: ignore[override]
        return ConfigNode(self.to_dict())


def load_yaml(path: str) -> ConfigNode:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return ConfigNode(data)


def from_dotlist(dotlist: Iterable[str]) -> ConfigNode:
    """Parse ``key.subkey=value`` items; values are YAML-typed
    (``1`` -> int, ``true`` -> bool, ``[1,2]`` -> list, ``null`` -> None)."""
    cfg = ConfigNode()
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"Override {item!r} is not of the form key=value")
        key, raw = item.split("=", 1)
        cfg.set_dotted(key.strip(), yaml.safe_load(raw) if raw != "" else None)
    return cfg


def load_config(
    default_path: str,
    config_file: Optional[str] = None,
    dotlist: Optional[List[str]] = None,
) -> ConfigNode:
    """Three-way merge: defaults <- config_file <- CLI dotlist
    (mirrors the original EmerNeRF's train_emernerf.py:125-127)."""
    cfg = load_yaml(default_path)
    user = ConfigNode()
    if config_file:
        user.merge_(load_yaml(config_file))
    if dotlist:
        user.merge_(from_dotlist(dotlist))
    cfg.merge_(user)
    normalize_default_interactions(cfg, user)
    return cfg


def normalize_default_interactions(cfg: "ConfigNode",
                                   user: Optional[Dict[str, Any]]) -> None:
    """Default-interaction normalization AFTER user overrides merge
    (ADVICE r3 #2): staged lidar-K (nerf.sampling.lidar_topk_until,
    default 0.9 since round 3) is meaningless under
    optim.fused_lidar_branch — one combined render has one sample_topk.
    A user opting into the fused branch on an otherwise-default config
    must not hit build_train_step's hard conflict error for a knob they
    never touched, so the DEFAULT value yields to the fused branch; an
    EXPLICIT user setting of both still errors (step.py).

    ``user`` holds ONLY the user-provided overrides (a ConfigNode or
    nested dict; None = no overrides).  Every entry point that merges
    overrides itself (flagship.py) must call this afterwards — the
    round-4 review found the load_config-only placement let
    build_flagship(overrides=[...]) bypass the fix."""
    user_until = None
    if user is not None:
        user_node = user if isinstance(user, ConfigNode) else ConfigNode(user)
        user_until = user_node.get_dotted("nerf.sampling.lidar_topk_until")
    if cfg.get_dotted("optim.fused_lidar_branch", False) and user_until is None:
        cfg.set_dotted("nerf.sampling.lidar_topk_until", 1.0)
