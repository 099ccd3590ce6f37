"""JAX param trees -> the port's modules.

Takes the model's tree and the tuple of proposal trees as nested dicts of
numpy arrays, as ``emernerf_tpu/train/step.py:init_train_state`` builds
them.  Flax ``TorchDense_i/Dense_0/{kernel,bias}`` becomes
``layers.i.{weight,bias}`` with the kernel ``(in, out)`` transposed to the
``Linear.weight`` ``(out, in)``; ``Embed.embedding`` becomes
``Embedding.weight``; ``*_table`` params (brick rows, or the hash grids'
feature-major ``(F, L*T)``) map straight across.  Any other leaf raises, as
does a state dict that does not cover the modules exactly.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
from torch import nn

_DENSE = re.compile(r"TorchDense_(\d+)")
_LEAVES = ("kernel", "bias", "embedding",
           "xyz_table", "dynflow_table", "dynamic_table", "flow_table", "hash_table")


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """One flax param tree -> a torch state dict (fp32 tensors; the module's
    ``load_state_dict`` casts to each param's dtype)."""
    out = {}
    for path, leaf in _flatten(tree):
        if path[-1] not in _LEAVES:
            raise ValueError(f"unmapped JAX param {'/'.join(path)}")
        arr = np.asarray(leaf).astype(np.float32)  # bf16 -> fp32 is exact
        names = []
        for p in path:
            m = _DENSE.fullmatch(p)
            if m:
                names += ["layers", m.group(1)]
            elif p == "Dense_0":
                continue
            elif p == "kernel":
                names.append("weight")
                arr = arr.T
            elif p == "embedding":
                names.append("weight")
            else:
                names.append(p)
        out[".".join(names)] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_jax_params(model: nn.Module, prop_models: Sequence[nn.Module],
                    params: Mapping, prop_params: Sequence[Mapping]) -> None:
    """Copy JAX params into the port's modules; every param must match."""
    if len(prop_models) != len(prop_params):
        raise ValueError(f"{len(prop_models)} prop models, {len(prop_params)} trees")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    for pm, pp in zip(prop_models, prop_params):
        pm.load_state_dict(state_dict_from_jax(pp), strict=True)
