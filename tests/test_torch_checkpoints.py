"""The port's checkpoints on the CPU: save and load of the whole train state
(params, Adam moments in their stored dtypes, counts, step), the ordering of
``latest_checkpoint``, and a JAX ``TrainState`` saved by the JAX package's
orbax ``save_checkpoint`` entering the port through ``load_jax_train_state``
and taking the same next step as JAX.

The tiny tables get bf16 Adam moments here: the moment-storage threshold
(2^20 elements in both packages) is lowered to 2^10 in both, so the
moments' dtypes cross the save, the load and the converter.

Tolerances of the next step: those of ``tests/test_torch_train_step.py``
(losses rtol 1e-4, gradients rtol 1e-3 + 2e-3 x the tensor's largest
|grad|); the Adam moments after the step the same for fp32 moments and one
bf16 ulp (rtol 2^-7) for bf16 moments, where the two packages round fp32
values that differ in the last bits.
"""

import jax
import numpy as np
import pytest
import torch
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

import emernerf_tpu.train.optim as jax_optim
from emernerf_tpu.train.checkpoints import load_checkpoint as jax_load_checkpoint
from emernerf_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint
from emernerf_torch.convert import load_jax_train_state
from emernerf_torch.flagship import DEFAULT_PROFILE, flagship_config, flagship_flow_spec
from emernerf_torch.train import optim
from emernerf_torch.train.checkpoints import latest_checkpoint, load_checkpoint, save_checkpoint
from emernerf_torch.train.trainer import Trainer

SMALL_BF16_MOMENTS = 1 << 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def bf16_moments(monkeypatch):
    monkeypatch.setattr(optim, "_BF16_MOMENT_MIN_ELEMS", SMALL_BF16_MOMENTS)
    monkeypatch.setattr(jax_optim, "_BF16_MOMENT_MIN_ELEMS", SMALL_BF16_MOMENTS)


def _trainer(seed=0):
    cfg = flagship_config(tiny=True, overrides=[f"optim.seed={seed}"])
    return Trainer(cfg, device="cpu", flow=flagship_flow_spec(cfg, tiny=True))


def _tensors(state):
    """Every tensor of a train state, named."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, pm in enumerate(state.prop_models):
        out.update({f"prop{i}.{k}": v for k, v in pm.state_dict().items()})
    for tag, s in (("opt", state.opt_state), ("prop_opt", state.prop_opt_state)):
        out.update({f"{tag}.mu{i}": m for i, m in enumerate(s.mu)})
        out.update({f"{tag}.nu{i}": m for i, m in enumerate(s.nu)})
    return out


def test_save_then_load_is_bit_exact(tmp_path, bf16_moments):
    trained = _trainer()
    for step in range(2):
        trained.train_iteration(step)
    path = save_checkpoint(str(tmp_path), trained.state)
    assert path.endswith("checkpoint_00002")
    assert not list(tmp_path.glob(".checkpoint_*"))  # no temporary file left
    fresh = _trainer(seed=5)
    saved, before = _tensors(trained.state), _tensors(fresh.state)
    assert any(not torch.equal(before[k], v) for k, v in saved.items())
    assert load_checkpoint(path, fresh.state) is fresh.state
    loaded = _tensors(fresh.state)
    assert set(loaded) == set(saved)
    for k, v in saved.items():
        assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k
    assert any(v.dtype == torch.bfloat16 for k, v in loaded.items() if ".mu" in k)
    assert fresh.state.step == trained.state.step == 2
    assert fresh.state.opt_state.count == trained.state.opt_state.count > 0
    assert fresh.state.prop_opt_state.count == trained.state.prop_opt_state.count > 0


def test_load_rejects_another_structure(tmp_path, bf16_moments, monkeypatch):
    path = save_checkpoint(str(tmp_path), _trainer().state)
    monkeypatch.setattr(optim, "_BF16_MOMENT_MIN_ELEMS", 1 << 20)  # fp32 moments
    with pytest.raises(ValueError, match="moment"):
        load_checkpoint(path, _trainer().state)


def test_latest_checkpoint_ordering(tmp_path):
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    for step in (9, 10, 2, 100):
        (tmp_path / f"checkpoint_{step:05d}").write_bytes(b"")
    (tmp_path / ".checkpoint_00200.tmp").write_bytes(b"")  # a save cut short
    (tmp_path / "metrics.json").write_text("")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint_00100")


def test_jax_train_state_continues_in_the_port(tmp_path, taps, bf16_moments,  # noqa: F811
                                               monkeypatch):
    """A JAX tiny-flagship TrainState after one step, saved with orbax and
    restored by the JAX package, loaded through load_jax_train_state: the
    port's next step matches JAX's next step in every loss, every gradient
    and the Adam moments it leaves."""
    js = _jax_side(taps, DEFAULT_PROFILE, FP32 + WIDE)
    first = Pair(js)
    first.run(*first.batches(0), True, True, seed=7, monkeypatch=monkeypatch)
    path = jax_save_checkpoint(str(tmp_path), first.jstate)
    assert path.endswith("checkpoint_00001")
    restored = jax.tree.map(np.asarray, jax_load_checkpoint(path, first.jstate))
    adam, prop_adam = restored.opt_state[1], restored.prop_opt_state[1]

    pair = Pair(js)  # fresh port modules at the initial params
    state = load_jax_train_state(pair.tstate, restored.params, restored.prop_params,
                                 (adam.count, adam.mu, adam.nu),
                                 (prop_adam.count, prop_adam.mu, prop_adam.nu),
                                 restored.step)
    assert state is pair.tstate and state.step == 1
    assert state.opt_state.count == int(adam.count) == 2  # pixel and lidar updates
    jp = {**{f"model.{k}": v for k, v in _named(restored.params, False).items()},
          **{f"prop.{k}": v for k, v in _named(restored.prop_params, True).items()}}
    ours = {**{f"model.{n}": p for n, p in state.model.named_parameters()},
            **{f"prop.{n}": p for n, p in zip(pair.prop_names, state.prop_params)}}
    assert set(ours) == set(jp)
    for k, v in jp.items():
        assert torch.equal(ours[k].detach().float(), v), k
    moments = [(state.opt_state, adam, pair.names, False),
               (state.prop_opt_state, prop_adam, pair.prop_names, True)]
    for ours_s, theirs, names, prop in moments:
        for mine, tree in ((ours_s.mu, theirs.mu), (ours_s.nu, theirs.nu)):
            ref = _named(tree, prop)
            assert any(m.dtype == torch.bfloat16 for m in mine)
            for name, m in zip(names, mine):
                assert torch.equal(m.float(), ref[name]), name

    pair.jstate = jax.tree.map(jax.numpy.asarray, restored)
    jm, tm, jgrads, tgrads = pair.run(*pair.batches(1), True, True, seed=8,
                                      monkeypatch=monkeypatch)
    _assert_losses_close(tm, jm)
    order = ["prop", "model", "prop", "model"]
    assert len(jgrads) == len(tgrads) == len(order)
    for kind, jg, tg in zip(order, jgrads, tgrads):
        _assert_grads_close(_named(jg, kind == "prop"), tg,
                            pair.prop_names if kind == "prop" else pair.names)
    after = [(state.opt_state, pair.jstate.opt_state[1], pair.names, False),
             (state.prop_opt_state, pair.jstate.prop_opt_state[1], pair.prop_names, True)]
    for ours_s, theirs, names, prop in after:
        assert ours_s.count == int(theirs.count) == 4
        for mine, tree in ((ours_s.mu, theirs.mu), (ours_s.nu, theirs.nu)):
            ref = _named(jax.tree.map(np.asarray, tree), prop)
            for name, m in zip(names, mine):
                r = ref[name].numpy()
                rtol = 2 ** -7 if m.dtype == torch.bfloat16 else 1e-3
                np.testing.assert_allclose(m.float().numpy(), r, rtol=rtol,
                                           atol=2e-3 * float(np.abs(r).max()), err_msg=name)
