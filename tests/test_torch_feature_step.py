"""Port parity of one training iteration with the feature head: the tiny
flagship of ``test_torch_train_step`` (widened, fp32, tables scaled) on
the Waymo-layout scene of ``test_torch_features``, with the feature head,
the learnable PE map and the feature loss on, both branches with proposal
gradients.  The draws and the gradients handed to Adam come out of the
jitted JAX step through ``test_torch_train_step``'s taps; every loss
(``feature_loss`` included) and every gradient, the feature head's and
the PE map's included, is held to JAX at that file's tolerances.  The
pixel batch carries the features gathered at its pixels and the pixel
coordinates; the lidar branch renders densities only, so the feature and
PE heads take gradients from the pixel branch alone.

This step is a JAX compile of its own (a different model and dataset
from every other whole-step comparison), in a file of its own so that
the suite's workers run it beside ``test_torch_train_step``.
"""

import numpy as np
import pytest
import torch
from test_torch_features import waymo_overrides, write_scene
from test_torch_train_step import (  # noqa: F401  (taps is a fixture)
    FP32,
    WIDE,
    Pair,
    _assert_grads_close,
    _assert_losses_close,
    _jax_side,
    _named,
    taps,
)

from emernerf_torch.flagship import DEFAULT_PROFILE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def feature_jax_side(taps, tmp_path_factory):  # noqa: F811
    return _jax_side(taps, DEFAULT_PROFILE, FP32 + WIDE + waymo_overrides(
        write_scene(tmp_path_factory)))


def test_feature_loss_iteration_matches_jax(feature_jax_side, monkeypatch):
    pair = Pair(feature_jax_side)
    cfg = pair.tstep.cfg
    assert cfg.use_feature_loss and pair.tstate.model.enable_feature_head
    pb, lb = pair.batches(0)
    assert pb["features"].shape == (feature_jax_side["r"], 16) and "pixel_coords" in pb
    jm, tm, jgrads, tgrads = pair.run(pb, lb, True, True, seed=7, monkeypatch=monkeypatch)
    _assert_losses_close(tm, jm)
    assert jm["feature_loss"] > 0 and jm["prop_loss"] > 0
    order = ["prop", "model", "prop", "model"]
    assert len(jgrads) == len(tgrads) == len(order)
    for kind, jg, tg in zip(order, jgrads, tgrads):
        _assert_grads_close(_named(jg, kind == "prop"), tg,
                            pair.prop_names if kind == "prop" else pair.names)
    # the pixel branch trains the feature head and the PE map; the lidar
    # branch (densities only) leaves them without a gradient
    pixel = dict(zip(pair.names, tgrads[1]))
    lidar = dict(zip(pair.names, tgrads[3]))
    for name in ("learnable_pe_map", "pe_head.layers.0.weight", "dino_head.layers.2.weight",
                 "dino_sky_head.layers.2.weight"):
        assert pixel[name] is not None and float(pixel[name].abs().max()) > 0, name
        assert lidar[name] is None or not np.any(lidar[name].numpy()), name
