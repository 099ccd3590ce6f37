"""JAX param trees -> the port's modules.

Takes the model's tree and the tuple of proposal trees as nested dicts of
numpy arrays, as ``emernerf_tpu/train/step.py:init_train_state`` builds
them.  Flax ``TorchDense_i/Dense_0/{kernel,bias}`` becomes
``layers.i.{weight,bias}`` with the kernel ``(in, out)`` transposed to the
``Linear.weight`` ``(out, in)``; ``Embed.embedding`` becomes
``Embedding.weight``; ``*_table`` params (brick rows, or the hash grids'
feature-major ``(F, L*T)``) and the ``learnable_pe_map`` (H, W, C) map
straight across.  Any other leaf raises, as
does a state dict that does not cover the modules exactly.

:func:`load_jax_train_state` takes a whole JAX ``TrainState`` (params,
Adam moments and counts, step), so that a JAX-trained run continues in the
port; the orbax checkpoint itself is read by the JAX package.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

_DENSE = re.compile(r"TorchDense_(\d+)")
_LEAVES = ("kernel", "bias", "embedding", "learnable_pe_map",
           "xyz_table", "dynflow_table", "dynamic_table", "flow_table", "hash_table")


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _named_leaves(tree: Mapping):
    """(torch name, numpy array in the torch layout) of every leaf."""
    for path, leaf in _flatten(tree):
        if path[-1] not in _LEAVES:
            raise ValueError(f"unmapped JAX param {'/'.join(path)}")
        arr = np.asarray(leaf)
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
        yield ".".join(names), arr


def state_dict_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """One flax param tree -> a torch state dict (fp32 tensors; the module's
    ``load_state_dict`` casts to each param's dtype)."""
    return {name: torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))  # bf16 exact
            for name, arr in _named_leaves(tree)}


def load_jax_params(model: nn.Module, prop_models: Sequence[nn.Module],
                    params: Mapping, prop_params: Sequence[Mapping]) -> None:
    """Copy JAX params into the port's modules; every param must match."""
    if len(prop_models) != len(prop_params):
        raise ValueError(f"{len(prop_models)} prop models, {len(prop_params)} trees")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    for pm, pp in zip(prop_models, prop_params):
        pm.load_state_dict(state_dict_from_jax(pp), strict=True)


def _load_moments(label: str, moments, names, jax_trees: Sequence[Mapping]) -> None:
    """Copy JAX moment trees into the port's moment tensors (ordered as
    ``names``), each in its stored dtype: bf16 stays bf16, exactly."""
    got = {}
    for prefix, tree in jax_trees:
        got.update({prefix + k: v for k, v in _named_leaves(tree)})
    if set(got) != set(names):
        raise ValueError(f"{label}: JAX moments {sorted(got)} != params {names}")
    for name, m in zip(names, moments):
        arr = got[name]
        if tuple(arr.shape) != tuple(m.shape) or str(arr.dtype) != str(m.dtype)[6:]:
            raise ValueError(f"{label} {name}: JAX {arr.dtype} {arr.shape}, "
                             f"port {m.dtype} {tuple(m.shape)}")
        m.copy_(torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32))))


@torch.no_grad()
def load_jax_train_state(state, params: Mapping, prop_params: Sequence[Mapping],
                         adam: Tuple, prop_adam: Tuple, step: int):
    """Fill the port's ``TrainState`` from a JAX ``TrainState`` given as
    numpy trees: ``params`` and ``prop_params`` as for
    :func:`load_jax_params`; ``adam`` and ``prop_adam`` the ``(count, mu,
    nu)`` of the two optax ``ScaleByAdamState``s (the proposal moments a
    sequence of trees, one per proposal net); ``step`` the iteration.
    Returns the state."""
    load_jax_params(state.model, state.prop_models, params, prop_params)
    names = [n for n, _ in state.model.named_parameters()]
    prop_names = [f"{i}.{n}" for i, pm in enumerate(state.prop_models)
                  for n, _ in pm.named_parameters()]
    for label, ours, (count, mu, nu), trees, keys in (
            ("opt_state", state.opt_state, adam, lambda t: [("", t)], names),
            ("prop_opt_state", state.prop_opt_state, prop_adam,
             lambda t: [(f"{i}.", x) for i, x in enumerate(t)], prop_names)):
        _load_moments(label + ".mu", ours.mu, keys, trees(mu))
        _load_moments(label + ".nu", ours.nu, keys, trees(nu))
        ours.count = int(count)
    state.step = int(step)
    return state
