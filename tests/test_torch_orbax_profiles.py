"""The JAX package's orbax checkpoints of the tiny flagship's other profiles
through the port's CLI on the CPU.

Three committed fixtures, each written as ``tests/data/jax_orbax_tiny/`` is
(``test_torch_orbax.py:write_fixture``: the tiny fp32 profile trained 100
JAX iterations, every 4th timestep held out, saved by the JAX package's
checkpointer, with JAX's held-out PSNR, SSIM and lidar depth RMSE and each
leaf's shape, dtype and float64 sum in ``expected.json``):
- ``jax_orbax_hash``: ``REFERENCE_HASH`` (exact hash grids, separate
  dynamic and flow tables of unpaired 4D rows; the port reads them with K4);
- ``jax_orbax_mx``: the flagship with ``nerf.model.grid_backend=mx`` (the
  MX grid's lines and scales; K12), its static grid cut to 2 levels and
  every MX grid to rank 4 (the tiny MX flagship's state is 16 MB on disk);
- ``jax_orbax_dynamic``: ``DYNAMIC`` (the shadow head, no flow grid or
  flow MLP).
Held for each: every leaf the reader gives equals orbax's restore bit for
bit and ``expected.json``'s record; the CLI's ``--eval_only`` meets JAX's
held-out PSNR within 0.1 dB and SSIM within 2e-3
(``test_torch_quality.py``'s tolerances); the port's held-out lidar depth
RMSE, taken as ``test_torch_quality.py:_held_out`` takes it (every held-out
frame's lidar rays, the evaluated model), meets JAX's within
``DEPTH_RTOL``; ``--auto_resume`` in a run directory of two of the
fixture's checkpoints takes the newer and trains two iterations.
``test_torch_orbax.py`` holds the brick fixture's held-out lidar depth the
same way.

``DEPTH_RTOL`` (``test_torch_orbax.py``'s): the port's eval renders the
same model as JAX's in fp32 in another order of operations.  Measured on
the CPU, relative to JAX's: 0 (brick, dynamic), 9.7e-8 (MX), 1.5e-7 (hash);
the test prints each.  1e-4 (under a millimetre at these 6-10 m RMSEs)
leaves room for rounding and none for a wrong depth.

A JAX ZeRO directory (the explicit ZeRO layout of 2 devices that
``test_torch_orbax.py`` writes in a subprocess, here with random moments
at step 37) resumes through the CLI's run on 2 spawned gloo ranks
(``parallel.num_devices=2 --device cpu``, the spawn of
``test_torch_parallel.py``): each rank's Adam moments equal that rank's
rows of the single-process read bit for bit, and one iteration runs on
both ranks to the same parameters.

The fixtures are written by ``PYTHONPATH=.:tests python
tests/test_torch_orbax_profiles.py --write-fixture hash mx dynamic`` (JAX
on the CPU, 1-2 minutes each).
"""

import json
import os
import shutil
import sys

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from test_torch_orbax import (
    DEPTH_RTOL,
    FIXTURE_STEP,
    PSNR_DB,
    SSIM_ABS,
    assert_bit_equal,
    leaf_summary,
    tiny_flow_spec,
    trainer_depth_rmse,
)
from test_torch_train_step import HASH_WIDE, WIDE

from emernerf_torch import flagship
from emernerf_torch.flagship import DYNAMIC, REFERENCE_HASH, Profile
from emernerf_torch.train import orbax_read
from emernerf_torch.train.checkpoints import latest_checkpoint

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# name: (profile, its widening dotlist, fixture directory)
PROFILES = {
    "hash": (REFERENCE_HASH, HASH_WIDE, "jax_orbax_hash"),
    # one dense level and one factored scale in the static grid, rank 4:
    # the tiny MX flagship's dense brick prefix and rank-16 lines are 16 MB
    "mx": (Profile(None, ("nerf.model.grid_backend=mx", "nerf.model.xyz_encoder.n_levels=2",
                          "nerf.model.perf.mx_rank=4")), WIDE, "jax_orbax_mx"),
    "dynamic": (DYNAMIC, WIDE, "jax_orbax_dynamic"),
}


def fixture_dir(name):
    return os.path.join(HERE, "data", PROFILES[name][2])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fixture_meta(name):
    with open(os.path.join(fixture_dir(name), "expected.json")) as f:
        return json.load(f)


def fixture_path(name):
    return os.path.join(fixture_dir(name), f"checkpoint_{FIXTURE_STEP:05d}")


def profile_argv(name, out_root, run_name, *flags, dots=()):
    """The CLI's arguments for fixture ``name``'s config (its profile's
    config file, the flagship and tiny dotlists, the profile's and the
    fixture's overrides, then ``dots``) on ``--device cpu``."""
    meta = fixture_meta(name)
    cfg_file = meta["profile"]["config_file"]
    return (["--device", "cpu", "--output_root", str(out_root), "--project", "p",
             "--run_name", run_name]
            + (["--config_file", os.path.join(REPO, cfg_file)] if cfg_file else [])
            + list(flags) + list(flagship._FLAGSHIP_DOTLIST) + list(flagship._TINY_DOTLIST)
            + list(meta["profile"]["overrides"]) + list(meta["overrides"])
            + ["render.render_low_res=false", "render.render_full=false",
               "logging.saveckpt_freq=1000000", *dots])


def fixture_bytes(root):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_committed_fixture_matches_orbax_restore_and_its_record(name):
    meta = fixture_meta(name)
    path = fixture_path(name)
    ours = orbax_read.read_tree(path)
    assert_bit_equal(ours, ocp.StandardCheckpointer().restore(path))
    assert leaf_summary(ours) == meta["leaves"]
    assert int(ours["step"]) == meta["step"] == FIXTURE_STEP
    assert fixture_bytes(fixture_dir(name)) <= 4 << 20
    assert sum(fixture_bytes(fixture_dir(n)) for n in PROFILES) <= 10 << 20
    # the profile's own leaves
    params = ours["params"]
    if name == "hash":
        assert {"dynamic_table", "flow_table"} <= set(params) and "dynflow_table" not in params
    elif name == "mx":
        assert {"xyz_table", "dynflow_table"} <= set(params)
    else:
        assert "flow_mlp" not in params and "dynamic_table" in params and "shadow_head" in params


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_cli_eval_only_meets_jax(name, tmp_path):
    """``--eval_only resume_from=<fixture>``: the held-out PSNR and SSIM the
    CLI writes, and the evaluated model's held-out lidar depth RMSE,
    against JAX's (``expected.json``)."""
    from emernerf_torch.train_emernerf import main

    with tiny_flow_spec():
        trainer = main(profile_argv(name, tmp_path, "ev", "--eval_only",
                                    f"resume_from={fixture_path(name)}"))
    got = json.load(open(tmp_path / "p" / "ev" / f"metrics_test_{FIXTURE_STEP}.json"))
    want = fixture_meta(name)["held_out"]
    depth = trainer_depth_rmse(trainer)
    print(f"{name}: port {got}, depth_rmse {depth!r}\nJAX {want}\n"
          f"depth relative {abs(depth - want['depth_rmse']) / want['depth_rmse']:.3e}")
    assert trainer.start_step == FIXTURE_STEP
    assert abs(got["psnr"] - want["psnr"]) <= PSNR_DB, (got, want)
    assert abs(got["ssim"] - want["ssim"]) <= SSIM_ABS, (got, want)
    assert abs(depth - want["depth_rmse"]) <= DEPTH_RTOL * want["depth_rmse"], (depth, want)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_auto_resume_trains_two_iterations(name, tmp_path):
    """A JAX run directory holding two of the fixture's checkpoints:
    ``--auto_resume`` takes the newer and trains two iterations from it."""
    from emernerf_torch.train_emernerf import main

    run = tmp_path / "p" / "ar"
    run.mkdir(parents=True)
    shutil.copytree(fixture_path(name), run / f"checkpoint_{FIXTURE_STEP:05d}")
    shutil.copytree(fixture_path(name), run / "checkpoint_00040")
    assert latest_checkpoint(str(run)) == str(run / f"checkpoint_{FIXTURE_STEP:05d}")
    with tiny_flow_spec():
        # the loop runs to optim.num_iters inclusive: steps 100 and 101
        trainer = main(profile_argv(name, tmp_path, "ar", "--auto_resume",
                                    dots=[f"optim.num_iters={FIXTURE_STEP + 1}",
                                          "logging.print_freq=1"]))
    assert trainer.start_step == FIXTURE_STEP
    assert trainer.state.step == FIXTURE_STEP + 2
    assert os.path.isfile(run / f"checkpoint_{FIXTURE_STEP + 2:05d}")
    losses = [json.loads(line)["rgb_loss"] for line in open(run / "metrics.json")]
    assert len(losses) == 2 and np.isfinite(losses).all()


# ------------------------------------------------- a JAX ZeRO directory
_ZERO_WRITER = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = [{repo!r}, {tests!r}]
import jax, jax.numpy as jnp, numpy as np
import emernerf_tpu.train.optim as jax_optim
jax_optim._BF16_MOMENT_MIN_ELEMS = {small}
from jax.sharding import Mesh
from emernerf_tpu.parallel.spmd import SpmdConfig, shard_state
from emernerf_tpu.train.checkpoints import save_checkpoint
from test_torch_orbax import _tiny_jax_state
rng = np.random.default_rng(0)
fill = lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype)
def moments(opt, count):
    wd, adam = opt
    return (wd, adam._replace(count=jnp.asarray(count, jnp.int32), mu=jax.tree.map(fill, adam.mu),
                              nu=jax.tree.map(lambda x: jnp.abs(fill(x)), adam.nu)))
state = _tiny_jax_state()
state = state.replace(step=jnp.asarray({step}, jnp.int32),
                      opt_state=moments(state.opt_state, 2 * {step}),
                      prop_opt_state=moments(state.prop_opt_state, 2 * {step}))
mesh = Mesh(np.array(jax.devices()), ("data",))
state = shard_state(state, mesh, SpmdConfig(zero=True, zero_min_elems={small}))
sharded = [x.sharding.spec for x in jax.tree.leaves(state.opt_state)]
assert any(len(s) and s[0] == "data" for s in sharded), sharded
# each Adam moment's shard that mesh device d holds (the whole moment where
# it is replicated), as numpy
def on(d):
    dev = mesh.devices.reshape(-1)[d]
    def shard(x):
        [data] = [s.data for s in x.addressable_shards if s.device == dev]
        return np.asarray(data)
    out = {{}}
    for k, opt in (("model", state.opt_state), ("prop", state.prop_opt_state)):
        for m in ("mu", "nu"):
            out[k + "." + m] = jax.tree.map(shard, getattr(opt[1], m))
    return out
with open({shards!r}, "wb") as f:
    pickle.dump([on(d) for d in range(2)], f)
print(save_checkpoint({out!r}, state))
"""
ZERO_STEP = 37


def _zero_rank(rank, init, out, path, shards, argv):
    """One of 2 spawned ranks: the CLI's run (``train_emernerf.run``) of
    ``argv`` resumed from the JAX ZeRO directory ``path``; writes whether
    this rank's moments as loaded are JAX's shards of mesh device ``rank``
    (``shards``: the writer's pickle of each device's), whether its routed
    moments differ from the other device's, whether they are its rows of
    the single-process read, and the steps."""
    import dataclasses
    import pickle

    import torch.distributed as dist
    from test_torch_orbax import SMALL_BF16_MOMENTS, _port_state, _tensors

    from emernerf_torch import builders, train_emernerf
    from emernerf_torch.convert import adam_states_from_jax
    from emernerf_torch.parallel.mesh import init_data_parallel
    from emernerf_torch.parallel.spmd import _jax_view, moment_rows
    from emernerf_torch.train import optim
    from emernerf_torch.train import trainer as trainer_mod
    from emernerf_torch.train.checkpoints import load_checkpoint

    torch.set_num_threads(1)
    optim._BF16_MOMENT_MIN_ELEMS = SMALL_BF16_MOMENTS
    spmd_config = trainer_mod.spmd_config
    trainer_mod.spmd_config = lambda cfg: dataclasses.replace(
        spmd_config(cfg), zero_min_elems=SMALL_BF16_MOMENTS)
    builders.flow_spec = flagship.tiny_flow_spec
    loaded = {}

    class Loaded(trainer_mod.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            st = self.state
            loaded.update(step=st.step, zero=st.zero, moments=[
                [m.clone() for m in s.mu + s.nu] for s in (st.opt_state, st.prop_opt_state)])

    train_emernerf.Trainer = Loaded
    group, device = init_data_parallel(2, "cpu", init_method=init, rank=rank)
    try:
        trainer = train_emernerf.run(train_emernerf.get_args_parser().parse_args(argv), group,
                                     device)
        whole = load_checkpoint(path, _port_state())
        with open(shards, "rb") as f:
            per_device = pickle.load(f)

        def device_moments(d):
            """Mesh device ``d``'s shards in the port's order and layout."""
            t = per_device[d]
            opt, prop = adam_states_from_jax(whole, (0, t["model.mu"], t["model.nu"]),
                                             (0, t["prop.mu"], t["prop.nu"]))
            return [opt["mu"] + opt["nu"], prop["mu"] + prop["nu"]]

        mine, other = device_moments(rank), device_moments(1 - rank)
        equal, jax_equal, distinct, big = [], [], [], 0
        for ours, theirs, route, jm, jo in zip(
                loaded["moments"], (whole.opt_state, whole.prop_opt_state),
                (loaded["zero"].model, loaded["zero"].prop), mine, other):
            n = len(theirs.mu)
            for i, (m, w) in enumerate(zip(ours, theirs.mu + theirs.nu)):
                rows = moment_rows(w, route, i % n, group)
                equal.append(m.dtype == rows.dtype and torch.equal(m, rows))
                # JAX's shard of this rank's device (in the JAX leaf's view
                # where the port routes it), and not the other device's
                routed = route.big[i % n]
                shard = _jax_view(jm[i], route.transposed[i % n]) if routed else jm[i]
                jax_equal.append(m.dtype == shard.dtype and torch.equal(m, shard))
                if routed:
                    big += 1
                    theirs_other = _jax_view(jo[i], route.transposed[i % n])
                    distinct.append(m.shape == theirs_other.shape
                                    and not torch.equal(m, theirs_other))
        torch.save({"equal": equal, "jax_equal": jax_equal, "distinct": distinct, "big": big,
                    "loaded_step": loaded["step"],
                    "start": trainer.start_step, "step": trainer.state.step,
                    "whole_rows": [int(t.shape[0]) for t in whole.opt_state.mu],
                    "params": {k: v for k, v in _tensors(trainer.state).items()
                               if k.startswith("model.")}},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_jax_zero_directory_resumes_on_two_spawned_ranks(tmp_path):
    """The JAX trainer's explicit ZeRO layout of 2 devices (random moments,
    step 37), written in a subprocess by the JAX package's checkpointer,
    resumed through the CLI's run on 2 spawned gloo ranks: each rank's
    moments as loaded are, bit for bit, the shards that JAX's mesh device
    of that rank held (the writer saves each device's) and its rows of the
    single-process read; each routed moment differs from the other
    device's; both ranks train one iteration to the same parameters."""
    import subprocess

    from test_torch_orbax import SMALL_BF16_MOMENTS
    from test_torch_parallel import spawn
    from test_torch_quality import overrides

    shards = str(tmp_path / "shards.pkl")
    code = _ZERO_WRITER.format(repo=REPO, tests=HERE, small=SMALL_BF16_MOMENTS,
                               out=str(tmp_path / "jax"), step=ZERO_STEP, shards=shards)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    path = r.stdout.strip().splitlines()[-1]
    argv = (["--device", "cpu", "--output_root", str(tmp_path / "runs"), "--project", "p",
             "--run_name", "zero"] + list(flagship._FLAGSHIP_DOTLIST)
            + list(flagship._TINY_DOTLIST) + overrides(10)
            + ["parallel.num_devices=2", f"resume_from={path}",
               # the loop runs to optim.num_iters inclusive: step 37 alone
               f"optim.num_iters={ZERO_STEP}", "render.render_low_res=false",
               "render.render_full=false", "logging.saveckpt_freq=1000000"])
    out = tmp_path / "ranks"
    out.mkdir()
    spawn(_zero_rank, tmp_path, str(out), path, shards, argv)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for r in ranks:
        assert r["equal"] and all(r["equal"]), r["equal"]
        assert r["jax_equal"] == r["equal"], r["jax_equal"]
        assert r["big"] > 0 and len(r["distinct"]) == r["big"]  # some moments are sharded
        assert all(r["distinct"]), r["distinct"]
        assert r["loaded_step"] == r["start"] == ZERO_STEP and r["step"] == ZERO_STEP + 1
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k


if __name__ == "__main__":
    import argparse

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_platforms", "cpu")
    parser = argparse.ArgumentParser(description="the profiles' fixture writer")
    parser.add_argument("--write-fixture", nargs="+", choices=sorted(PROFILES), required=True,
                        help="write tests/data/jax_orbax_<profile> (JAX on the CPU)")
    args = parser.parse_args()
    sys.path.insert(0, HERE)
    from test_torch_orbax import write_fixture

    for name in args.write_fixture:
        profile, widen, _ = PROFILES[name]
        write_fixture(fixture_dir(name), profile=profile, widen=widen)
