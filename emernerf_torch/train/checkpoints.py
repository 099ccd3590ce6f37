"""Checkpoint save/resume (port of ``emernerf_tpu/train/checkpoints.py``).

The full :class:`TrainState` (both modules' state dicts, both Adam states
with their moments in the stored dtypes, the step) is written with
``torch.save`` as ``checkpoint_{step:05d}`` under the log dir; resume
restores it in place on the state's device.  As in the JAX package no RNG
state is saved: a resumed run draws from its seed again.  A JAX-trained
state enters through ``emernerf_torch.convert.load_jax_train_state``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from emernerf_torch.train.optim import AdamState
from emernerf_torch.train.state import TrainState


def _adam_dict(s: AdamState):
    return {"count": int(s.count), "mu": list(s.mu), "nu": list(s.nu)}


def save_checkpoint(log_dir: str, state: TrainState) -> str:
    step = int(state.step)
    path = os.path.abspath(os.path.join(log_dir, f"checkpoint_{step:05d}"))
    payload = {
        "step": step,
        "model": state.model.state_dict(),
        "prop_models": [pm.state_dict() for pm in state.prop_models],
        "opt_state": _adam_dict(state.opt_state),
        "prop_opt_state": _adam_dict(state.prop_opt_state),
    }
    # written under another name first: a run killed mid-write leaves no
    # partial checkpoint_* for latest_checkpoint to pick
    tmp = os.path.join(log_dir, f".checkpoint_{step:05d}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _restore_adam(name: str, ours: AdamState, saved) -> None:
    if len(saved["mu"]) != len(ours.mu) or len(saved["nu"]) != len(ours.nu):
        raise ValueError(f"{name}: {len(saved['mu'])} moments saved, {len(ours.mu)} expected")
    for mine, theirs in zip(ours.mu + ours.nu, saved["mu"] + saved["nu"]):
        if mine.shape != theirs.shape or mine.dtype != theirs.dtype:
            raise ValueError(f"{name}: moment {tuple(theirs.shape)} {theirs.dtype} saved, "
                             f"{tuple(mine.shape)} {mine.dtype} expected")
        mine.copy_(theirs)
    ours.count = int(saved["count"])


@torch.no_grad()
def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore ``path`` into ``state`` in place (the structure, dtypes and
    device of an initialized state); returns it."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    if len(ckpt["prop_models"]) != len(state.prop_models):
        raise ValueError(f"{path}: {len(ckpt['prop_models'])} proposal nets saved, "
                         f"{len(state.prop_models)} expected")
    state.model.load_state_dict(ckpt["model"])
    for pm, sd in zip(state.prop_models, ckpt["prop_models"]):
        pm.load_state_dict(sd)
    _restore_adam("opt_state", state.opt_state, ckpt["opt_state"])
    _restore_adam("prop_opt_state", state.prop_opt_state, ckpt["prop_opt_state"])
    state.step = int(ckpt["step"])
    return state


def latest_checkpoint(log_dir: str) -> Optional[str]:
    if not os.path.isdir(log_dir):
        return None
    ckpts = sorted(d for d in os.listdir(log_dir) if d.startswith("checkpoint_"))
    return os.path.join(log_dir, ckpts[-1]) if ckpts else None
