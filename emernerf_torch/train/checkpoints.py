"""Checkpoint save/resume (port of ``emernerf_tpu/train/checkpoints.py``).

The full :class:`TrainState` (both modules' state dicts, both Adam states
with their moments in the stored dtypes, the step) is written with
``torch.save`` as ``checkpoint_{step:05d}`` under the log dir; resume
restores it in place on the state's device.  A ZeRO-sharded state
(``state.zero``) gathers its moment slabs on save, so the file is a
single process's, and takes its own rows on load: a run resumes at any
number of ranks.  As in the JAX package no RNG
state is saved: a resumed run draws from its seed again.

``load_checkpoint`` and ``latest_checkpoint`` also take the directories
the JAX package's orbax checkpointer writes (``checkpoint_XXXXX/`` with
``_METADATA`` and ``manifest.ocdbt``), read without JAX by
``emernerf_torch/train/orbax_read.py`` and converted by
``emernerf_torch.convert``: a JAX-trained run resumes, evaluates and
exports in the port, at any number of ranks, with no other flag.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from emernerf_torch.convert import adam_states_from_jax, load_jax_params
from emernerf_torch.parallel.spmd import gather_moments, moment_rows
from emernerf_torch.train import orbax_read
from emernerf_torch.train.optim import AdamState
from emernerf_torch.train.state import TrainState


def _adam_dict(s: AdamState):
    return {"count": int(s.count), "mu": list(s.mu), "nu": list(s.nu)}


def save_checkpoint(log_dir: Optional[str], state: TrainState) -> Optional[str]:
    """Write ``state`` under ``log_dir``; returns the path.  A ZeRO-sharded
    state first gathers its moments (every rank joins); the ranks that do
    not write pass ``log_dir`` None."""
    opt, prop_opt = state.opt_state, state.prop_opt_state
    if state.zero is not None:
        opt = gather_moments(opt, state.zero.model, state.zero.group)
        prop_opt = gather_moments(prop_opt, state.zero.prop, state.zero.group)
    if log_dir is None:
        return None
    step = int(state.step)
    path = os.path.abspath(os.path.join(log_dir, f"checkpoint_{step:05d}"))
    payload = {
        "step": step,
        "model": state.model.state_dict(),
        "prop_models": [pm.state_dict() for pm in state.prop_models],
        "opt_state": _adam_dict(opt),
        "prop_opt_state": _adam_dict(prop_opt),
    }
    # written under another name first: a run killed mid-write leaves no
    # partial checkpoint_* for latest_checkpoint to pick
    tmp = os.path.join(log_dir, f".checkpoint_{step:05d}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _restore_adam(name: str, ours: AdamState, saved, route=None, group=None) -> None:
    """``route``: the ZeRO routing of a sharded state, whose routed moments
    take this rank's rows of the saved whole ones."""
    if len(saved["mu"]) != len(ours.mu) or len(saved["nu"]) != len(ours.nu):
        raise ValueError(f"{name}: {len(saved['mu'])} moments saved, {len(ours.mu)} expected")
    n = len(ours.mu)
    for i, (mine, theirs) in enumerate(zip(ours.mu + ours.nu, saved["mu"] + saved["nu"])):
        if route is not None:
            theirs = moment_rows(theirs, route, i % n, group)
        if mine.shape != theirs.shape or mine.dtype != theirs.dtype:
            raise ValueError(f"{name}: moment {tuple(theirs.shape)} {theirs.dtype} saved, "
                             f"{tuple(mine.shape)} {mine.dtype} expected")
        mine.copy_(theirs)
    ours.count = int(saved["count"])


@torch.no_grad()
def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore ``path`` into ``state`` in place (the structure, dtypes and
    device of an initialized state); returns it.  ``path`` is the port's
    checkpoint file or a JAX orbax checkpoint directory."""
    if orbax_read.is_orbax_checkpoint(path):
        return _load_jax_checkpoint(path, state)
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    if len(ckpt["prop_models"]) != len(state.prop_models):
        raise ValueError(f"{path}: {len(ckpt['prop_models'])} proposal nets saved, "
                         f"{len(state.prop_models)} expected")
    state.model.load_state_dict(ckpt["model"])
    for pm, sd in zip(state.prop_models, ckpt["prop_models"]):
        pm.load_state_dict(sd)
    _restore_states(state, ckpt["opt_state"], ckpt["prop_opt_state"])
    state.step = int(ckpt["step"])
    return state


def _restore_states(state: TrainState, opt, prop_opt) -> None:
    z = state.zero
    _restore_adam("opt_state", state.opt_state, opt, z and z.model, z and z.group)
    _restore_adam("prop_opt_state", state.prop_opt_state, prop_opt, z and z.prop,
                  z and z.group)


def _load_jax_checkpoint(path: str, state: TrainState) -> TrainState:
    """A JAX ``TrainState`` saved by orbax: the params through the
    converter, the Adam states (ZeRO-sharded or not) as the port's own."""
    jax = orbax_read.read_jax_train_state(path)
    if len(jax["prop_params"]) != len(state.prop_models):
        raise ValueError(f"{path}: {len(jax['prop_params'])} proposal nets saved, "
                         f"{len(state.prop_models)} expected")
    load_jax_params(state.model, state.prop_models, jax["params"], jax["prop_params"])
    adam, prop_adam = (tuple(a[k] for k in ("count", "mu", "nu"))
                       for a in (jax["adam"], jax["prop_adam"]))
    _restore_states(state, *adam_states_from_jax(state, adam, prop_adam))
    state.step = jax["step"]
    return state


_CHECKPOINT = re.compile(r"checkpoint_(\d+)")


def latest_checkpoint(log_dir: str) -> Optional[str]:
    """The newest ``checkpoint_XXXXX`` under ``log_dir``: the port's file or
    a JAX orbax directory (other directories of that name, such as orbax's
    unfinished temporaries, are skipped)."""
    if not os.path.isdir(log_dir):
        return None
    found = []
    for d in os.listdir(log_dir):
        m = _CHECKPOINT.fullmatch(d)
        path = os.path.join(log_dir, d)
        if m and (os.path.isfile(path) or orbax_read.is_orbax_checkpoint(path)):
            found.append((int(m.group(1)), path))
    return max(found)[1] if found else None
