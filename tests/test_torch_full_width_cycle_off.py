"""The flagship at full width, one iteration at step 2,300 from a common
state, with the cycle loss's coefficient 0 in both packages' step configs
(``test_torch_full_width_step.py``'s ``FullWidth`` and tolerances).

The cycle loss is the pixel branch's only term that reaches the flow MLP
directly; with it on, its smooth share dominates the pixel branch's
flow-MLP gradient.  With it off, that gradient comes only through the
temporal aggregation, the fused grid read at the flow-warped points, as
the lidar branch's always does.  Held: the pixel branch alone in the port
from the common state, and the lidar branch alone from the parameters
JAX's pixel update returned, each against JAX's (every loss, every flow_mlp
leaf at ``FLOW_MLP_ATOL`` for the pixel branch and ``LIDAR_FLOW_MLP_ATOL``
for the lidar branch, the other leaves at that file's tolerances).

A file of its own: the step config differs, so JAX's step is a compile of
its own (about a minute), which ``--dist loadfile`` runs beside the other
file's.
"""

import pytest
import torch
from test_torch_full_width_step import FullWidth, assert_branch_matches_jax, jax_taps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cycle_off():
    with jax_taps() as taps:
        fw = FullWidth(taps, cycle_coef=0.0)
        yield fw, fw.jax_run(2300)


@pytest.mark.parametrize("branch", ["pixel", "lidar"])
def test_branch_without_the_cycle_loss_matches_jax(cycle_off, branch, monkeypatch):
    fw, rec = cycle_off
    assert fw.step_cfg.cycle_coef == fw.tcfg.cycle_coef == 0.0
    assert rec["metrics"]["cycle_loss"] == 0.0
    flow = assert_branch_matches_jax(fw, rec, branch == "lidar", monkeypatch)
    print(f"{branch} branch flow_mlp, largest |port - JAX| / max |JAX|: {flow}")
