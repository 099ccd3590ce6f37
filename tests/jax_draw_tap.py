"""The JAX package's random draws, passed out of its jitted step for the
port's parity tests (imported by ``test_torch_train_step.py`` and
``test_torch_quality.py``).

Inside :func:`uniform_tap`, ``jax.random.uniform`` is wrapped so that every
value it draws in a function traced there is passed out through a debug
callback, in program order (per branch of a training step: the stratified
jitters of each sampling level, the top-K Gumbel uniforms where the branch
prunes, the aggregation noise where there is flow).  A function traced
outside the context draws untapped, even when it runs inside it later.
:func:`step_draws` turns one branch's recorded arrays into the port's
``StepDraws``.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emernerf_torch.train.step import StepDraws


class Tap:
    """Collects values from inside a jitted JAX function through debug
    callbacks; ``take`` returns those of the last call in program order."""

    def __init__(self):
        self.slots = []

    def __call__(self, value):  # at trace time
        i = len(self.slots)
        self.slots.append(None)
        jax.debug.callback(functools.partial(self._put, i), value)

    def _put(self, i, value):
        self.slots[i] = jax.tree.map(np.asarray, value)

    def take(self):
        out = [v for v in self.slots if v is not None]
        self.slots = [None] * len(self.slots)
        return out


@contextlib.contextmanager
def uniform_tap():
    """Wrap ``jax.random.uniform`` while the context is open; yields the
    :class:`Tap` its draws go to."""
    tap = Tap()
    uniform = jax.random.uniform

    def tapped_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        v = uniform(key, shape, dtype, minval, maxval)
        tap(v)
        return v

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.random, "uniform", tapped_uniform)
        yield tap


def _layout(lidar: bool, step_cfg, full: bool):
    """(jitters, whether the top-K uniforms, whether the aggregation
    noise) that one branch draws."""
    topk = step_cfg.sample_topk
    if lidar and step_cfg.lidar_sample_topk >= 0:
        topk = step_cfg.lidar_sample_topk
    prune = 0 < topk < step_cfg.num_samples and not (lidar and full)
    return (len(step_cfg.prop_samples) + 1, prune and step_cfg.sample_topk_temp > 0,
            step_cfg.has_flow)  # the aggregation draws its noise where there is flow


def step_draws(recorded, lidar: bool, step_cfg, full: bool = False) -> StepDraws:
    """Split one branch's recorded uniforms into StepDraws (``full``: the
    lidar branch rendered unpruned, the staged lidar-K's last stretch)."""
    n_jit, with_topk, with_agg = _layout(lidar, step_cfg, full)
    t = [torch.from_numpy(np.array(v)) for v in recorded]
    jit, rest = t[:n_jit], t[n_jit:]
    topk_u = rest.pop(0) if with_topk else None
    agg = rest.pop(0) if with_agg else None
    assert not rest
    return StepDraws(tuple(jit), topk_u, agg)


def iteration_draws(recorded, step_cfg, full: bool = False):
    """One iteration's recorded uniforms as the (pixel, lidar) StepDraws."""
    n_pix = sum(_layout(False, step_cfg, False))
    return (step_draws(recorded[:n_pix], False, step_cfg),
            step_draws(recorded[n_pix:], True, step_cfg, full))
