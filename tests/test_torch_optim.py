"""Port parity: the optimizer (plain version of kernel K8) and the lr
schedule against ``emernerf_tpu.train.optim``, on the CPU.

Three Adam steps on one param of 2^20+ elements (bf16 moments) and one
small param (fp32 moments), with random gradients, a gradient-less step
for the small param (a zero gradient) and the schedule's learning rates.
Tolerance: params rtol 1e-6, atol 1e-9 (updates are ~lr = 1e-4 and
round at ~1e-11; a param near zero has no relative precision); moments
equal up to one rounding of their storage dtype (XLA may contract
b * m + (1 - b) * g into one FMA, the port rounds each op).  The
schedule: rtol 1e-6 at its milestones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emernerf_tpu.train.optim import apply_update as jax_apply_update
from emernerf_tpu.train.optim import chained_lr_schedule as jax_schedule
from emernerf_tpu.train.optim import make_adam as jax_make_adam
from emernerf_torch.train.optim import (
    AdamHyper,
    adam_update,
    apply_update,
    chained_lr_schedule,
    make_adam,
)

BIG = (1024, 1025)  # 1,049,600 elements >= 2^20: bf16 moments
SMALL = (7, 5)


def test_three_adam_steps_match_jax():
    rng = np.random.default_rng(0)
    params = {"big": rng.normal(size=BIG).astype(np.float32),
              "small": rng.normal(size=SMALL).astype(np.float32)}
    tx = jax_make_adam(1e-5)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = [torch.from_numpy(params["big"].copy()), torch.from_numpy(params["small"].copy())]
    adam = make_adam(1e-5)
    tstate = adam.init(tparams)
    assert [m.dtype for m in tstate.mu] == [torch.bfloat16, torch.float32]
    lr_fn = chained_lr_schedule(0.01, 25000)
    for count in range(3):
        grads = {k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-6, 1)).astype(np.float32)
                 for k, v in params.items()}
        if count == 1:
            grads["small"][:] = 0.0  # the port passes None: a param the branch did not use
        lr = lr_fn(count)
        jparams, jstate = jax_apply_update(tx, {k: jnp.asarray(v) for k, v in grads.items()},
                                           jstate, jparams, jnp.float32(lr))
        tgrads = [torch.from_numpy(grads["big"]),
                  None if count == 1 else torch.from_numpy(grads["small"])]
        apply_update(adam, tgrads, tstate, tparams, lr)
    adam_state = jstate[1]
    assert tstate.count == int(adam_state.count) == 3
    for i, k in enumerate(("big", "small")):
        np.testing.assert_allclose(tparams[i].numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                   atol=1e-9)
        for ours, ref in ((tstate.mu[i], adam_state.mu[k]), (tstate.nu[i], adam_state.nu[k])):
            ref = np.asarray(ref.astype(jnp.float32))
            ulp = 2.0 ** -7 if ours.dtype == torch.bfloat16 else 2.0 ** -23
            np.testing.assert_allclose(ours.float().numpy(), ref, rtol=ulp, atol=1e-30)


def test_adam_update_plain_follows_the_kernel_ops():
    """One element by hand, op for op as kernels/csrc/adam.cu computes it."""
    h = make_adam(1e-5).hyper(2, 0.005)
    f = np.float32
    p, g, m, v = f(0.75), f(-0.03), f(0.002), f(1e-5)
    gw = g + f(h.weight_decay) * p
    m1 = f(h.b1) * m + f(h.one_minus_b1) * gw
    v1 = f(h.b2) * v + (f(h.one_minus_b2) * gw) * gw
    want = p + f(h.neg_lr) * ((m1 / f(h.c1)) / (np.sqrt(v1 / f(h.c2)) + f(h.eps)))
    pt, mt, vt = (torch.tensor([x]) for x in (p, m, v))
    adam_update(pt, torch.tensor([g]), mt, vt, h)
    assert float(pt) == want and float(mt) == m1 and float(vt) == v1
    assert isinstance(h, AdamHyper) and h.c1 == float(f(1) - f(0.9) ** f(2))
    with pytest.raises(ValueError):
        adam_update(pt.double(), None, mt, vt, h)


@pytest.mark.parametrize("num_iters", [25000, 2000])
def test_lr_schedule_matches_jax_at_milestones(num_iters):
    ours, ref = chained_lr_schedule(0.01, num_iters), jax_schedule(0.01, num_iters)
    w = num_iters // 10
    counts = [0, 1, w - 1, w, w + 1, num_iters // 4, num_iters // 2 - 1, num_iters // 2,
              num_iters * 3 // 4, num_iters * 9 // 10, num_iters * 2]
    for c in counts:
        np.testing.assert_allclose(ours(c), float(ref(c)), rtol=1e-6, err_msg=str(c))
    assert ours(0) == pytest.approx(1e-4) and ours(w) == pytest.approx(0.01)
