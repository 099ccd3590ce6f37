"""Which package's proposal loss is nearer float64, at a trained state.

At the trained tiny state of ``tests/test_torch_quality.py`` the two
packages' proposal losses were 3.2e-4 apart (49.797 against JAX's 49.813;
ROADMAP queue 3), with the inputs of each from its own render.  Here both
``compute_prop_loss`` functions take the same inputs: the committed
fixture's state (``tests/data/jax_orbax_tiny/``, the tiny fp32 flagship
after 100 JAX iterations, read by the port's orbax reader), the pixel batch
of iteration 100 (the JAX sampler's) and the port's render of it (its
proposal caches, final intervals and transmittance).  The reference is the
JAX package's own formula evaluated in float64 (``jax.enable_x64``) on the
same inputs.  The port's loss scans in float64 inside K5's plain version
(ROADMAP queue 3, "kept by design"); JAX's sums in fp32.  Measured: float64
47.556896, the port 1.84e-6 from it, JAX 2.00e-6; the two 1.6e-7 apart.
Pinned: the port is nearer float64, both are within 1e-4 of it (relative)
and within 1e-5 of each other, so the 3.2e-4 between the two packages'
losses in the quality loop comes from their inputs (each package's own
render of the batch), not from this function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emernerf_torch.flagship import build_flagship
from emernerf_torch.render.prop_sampler import compute_prop_loss
from emernerf_torch.train.checkpoints import load_checkpoint
from emernerf_torch.train.state import init_train_state
from emernerf_torch.train.step import build_train_step, draw_step
from emernerf_tpu.render.prop_sampler import PropCache as JaxPropCache
from emernerf_tpu.render.prop_sampler import compute_prop_loss as jax_prop_loss

NEAR = 1e-4  # each package's relative distance from float64, at most


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    """The port's render of iteration 100's pixel batch at the fixture's
    state: (caches, final interval edges, transmittance, step config)."""
    from test_torch_orbax import FIXTURE_STEP, _fixture_meta, _fixture_path
    from test_torch_quality import Run

    meta = _fixture_meta()
    _, _, model, props, cfg = build_flagship(tiny=True, overrides=meta["overrides"],
                                             device="cpu")
    state = load_checkpoint(_fixture_path(), init_train_state(model, props))
    assert state.step == FIXTURE_STEP
    step = build_train_step(model, props, cfg)
    pb, _, _, _ = Run(iters=FIXTURE_STEP).iteration(FIXTURE_STEP)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in pb.items()}
    gen = torch.Generator().manual_seed(0)
    draws = draw_step(len(batch["origins"]), step.render_kw(False), model.has_flow, gen)
    with torch.no_grad():
        res = step._render(batch, draws, True, lidar=False)
    return res.caches, res.s_vals, res.out["extras"]["trans"], cfg


def _jax_loss(caches, s_vals, trans, cfg, dtype):
    def arr(t):
        return jnp.asarray(t.detach().numpy().astype(dtype))

    return float(jax_prop_loss([JaxPropCache(arr(c.s_vals), arr(c.cdfs), c.level)
                                for c in caches], arr(s_vals), arr(trans),
                               cfg.enable_anti_aliasing, tuple(cfg.pulse_widths),
                               cfg.prop_loss_scaler))


def test_port_prop_loss_is_nearer_float64_than_jax():
    caches, s_vals, trans, cfg = _inputs()
    port = float(compute_prop_loss(caches, s_vals, trans, cfg.enable_anti_aliasing,
                                   tuple(cfg.pulse_widths), cfg.prop_loss_scaler))
    ref32 = _jax_loss(caches, s_vals, trans, cfg, np.float32)
    with jax.enable_x64(True):
        ref64 = _jax_loss(caches, s_vals, trans, cfg, np.float64)
    d_port, d_jax = abs(port - ref64) / ref64, abs(ref32 - ref64) / ref64
    print(f"float64 {ref64!r}; port {port!r} ({d_port:.3g} apart); JAX {ref32!r} "
          f"({d_jax:.3g} apart)")
    assert ref64 > 0
    assert d_port <= NEAR and d_jax <= NEAR, (d_port, d_jax)
    assert d_port < d_jax, (d_port, d_jax)
    # on the same inputs the two functions agree far inside the 3.2e-4 that
    # their own renders' inputs put between them
    assert abs(port - ref32) / ref64 <= 1e-5
