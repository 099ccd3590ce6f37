"""The port's reader of the JAX package's orbax checkpoints
(``emernerf_torch/train/orbax_read.py``) on the CPU.

The JAX package writes with orbax's ``StandardCheckpointer`` (OCDBT, zarr
v2, zstd); the port reads without JAX, orbax or tensorstore, and every leaf
must equal ``StandardCheckpointer().restore``'s bit for bit:
- trees of fp32, bf16, int32 and uint32 leaves, 0-d leaves, leaves under
  and over OCDBT's 1,024-byte inline limit, nested dicts, tuples and empty
  (None) states;
- the tiny flagship's ``TrainState`` with bf16 moments, and the same state
  in the explicit ZeRO layout of 2 devices (written in a subprocess with
  ``--xla_force_host_platform_device_count=2``, by the JAX package's
  checkpointer, which gathers it to the host, and by orbax from the
  sharded arrays, 2 chunks a sharded moment); each then enters the port
  through ``load_checkpoint`` as the converter takes orbax's restore;
- the committed fixture ``tests/data/jax_orbax_tiny/`` (the tiny fp32
  flagship of ``tests/test_torch_quality.py:overrides`` after 100 JAX
  iterations, every 4th timestep held out), whose ``expected.json`` holds
  JAX's held-out PSNR and SSIM and each leaf's shape, dtype and float64
  sum; the CLI's ``--eval_only`` on it meets JAX's PSNR within 0.1 dB and
  SSIM within 2e-3 (``test_torch_quality.py``'s tolerances), and
  ``--auto_resume`` in a JAX run directory takes the newest
  ``checkpoint_XXXXX``.
A flipped byte in a B-tree node raises, naming the file, and without the
native zstd decoder ``load_checkpoint`` raises.  The port's next step from a
read state against JAX's is in ``tests/test_torch_checkpoints.py``, which
shares that file's whole-step compile.

The fixture is written by ``python tests/test_torch_orbax.py
--write-fixture`` (JAX on the CPU, about 2 minutes).
"""

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

import emernerf_torch.builders as port_builders
import emernerf_tpu.train.optim as jax_optim
from emernerf_torch.convert import load_jax_train_state
from emernerf_torch.eval.metrics import held_out_depth_rmse
from emernerf_torch import flagship
from emernerf_torch.flagship import build_flagship
from emernerf_torch.native import zstd as native_zstd
from emernerf_torch.train import optim
from emernerf_torch.train import orbax_read
from emernerf_torch.train.checkpoints import latest_checkpoint, load_checkpoint
from emernerf_torch.train.state import init_train_state
from emernerf_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXTURE = os.path.join(HERE, "data", "jax_orbax_tiny")
FIXTURE_STEP = 100
PSNR_DB, SSIM_ABS = 0.1, 2e-3  # tests/test_torch_quality.py's held-out tolerances
# the held-out lidar depth RMSE, port vs JAX, relative (measured at most
# 1.5e-7 over the four fixtures; tests/test_torch_orbax_profiles.py)
DEPTH_RTOL = 1e-4
SMALL_BF16_MOMENTS = 1 << 10  # both packages' bf16-moment threshold, lowered for tiny tables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x) -> np.ndarray:
    """A leaf's bytes as an unsigned array of its width (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.uint16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    x = np.ascontiguousarray(np.asarray(x))
    return x.reshape(-1).view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[
        x.dtype.itemsize]).reshape(x.shape)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.asarray(x).dtype.name


def _walk(tree, prefix=()):
    """(key path, leaf) of a nested dict / list / tuple tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _orbax_tree(restored):
    """orbax's restore as nested dicts / lists (named tuples and flax
    dataclasses by field name), the leaves numpy."""
    def conv(x):
        if hasattr(x, "_fields"):  # optax's states; an empty one is None
            return {f: conv(getattr(x, f)) for f in x._fields} if x._fields else None
        if hasattr(x, "__dataclass_fields__"):
            return {f: conv(getattr(x, f)) for f in x.__dataclass_fields__}
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        if x is None or (hasattr(x, "__len__") and not hasattr(x, "shape") and len(x) == 0):
            return None  # an empty optax state
        return np.asarray(x)

    return conv(restored)


def assert_bit_equal(ours, theirs):
    """Every leaf of the port's tree equals orbax's bit for bit, in dtype and
    shape; the two trees have the same leaves."""
    a, b = dict(_walk(ours)), dict(_walk(_orbax_tree(theirs)))
    assert set(a) == set(b), (sorted(set(a) ^ set(b)))
    for k in a:
        if b[k] is None:
            assert a[k] is None, k
            continue
        assert _dtype_name(a[k]) == _dtype_name(b[k]), (k, _dtype_name(a[k]), _dtype_name(b[k]))
        assert tuple(a[k].shape) == tuple(np.shape(b[k])), k
        assert np.array_equal(_bits(a[k]), _bits(b[k])), k


def _save(path, tree):
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(path), tree, force=True)
    ckptr.wait_until_finished()
    return os.path.abspath(path)


def _restore(path):
    return ocp.StandardCheckpointer().restore(os.path.abspath(path))


def _trees():
    rng = np.random.default_rng(0)
    return {
        "dtypes": {
            "f32": rng.standard_normal((37, 5)).astype(np.float32),
            "bf16": jnp.asarray(rng.standard_normal((3, 64)), jnp.bfloat16),
            "i32": rng.integers(-2**31, 2**31 - 1, (11,), dtype=np.int32),
            "u32": rng.integers(0, 2**32 - 1, (7, 3), dtype=np.uint32),
        },
        "zero_d": {"f32": np.float32(3.5), "i32": jnp.int32(-7), "bf16": jnp.bfloat16(0.3),
                   "step": jnp.asarray(2300, jnp.int32)},
        "inline_limit": {  # fp32 leaves around OCDBT's 1,024-byte inline limit
            "tiny": np.arange(3, dtype=np.float32),
            "under": rng.standard_normal(200).astype(np.float32),
            "at": rng.standard_normal(256).astype(np.float32),
            "over": rng.standard_normal(300).astype(np.float32),
            "big": rng.standard_normal((65536, 7)).astype(np.float32),
            "zeros": np.zeros((1000, 33), np.float32),
        },
        "nested": {"a": {"b": {"c": np.ones((2, 2), np.float32)}},
                   "seq": (np.zeros(3, np.float32), {"x": np.full(4, 2.0, np.float32)},
                           (np.int32(1), np.arange(5, dtype=np.int32))),
                   "state": (None, {"count": jnp.int32(4),
                                    "mu": {"w": np.ones(9, np.float32)}})},
    }


@pytest.mark.parametrize("name", ["dtypes", "zero_d", "inline_limit", "nested"])
def test_reader_matches_orbax_restore_bit_for_bit(tmp_path, name):
    tree = _trees()[name]
    path = _save(tmp_path / "ck", tree)
    before = native_zstd.frames
    ours = orbax_read.read_tree(path)
    assert native_zstd.frames > before  # the chunks went through the native decoder
    assert_bit_equal(ours, _restore(path))
    stats = orbax_read.last_read
    assert stats["arrays"] == sum(1 for _, v in _walk(tree) if v is not None)
    assert stats["decoded_bytes"] >= sum(np.asarray(v).nbytes for _, v in _walk(tree)
                                         if v is not None)


def test_missing_chunk_raises_unless_a_fill_value(tmp_path):
    """A zarr array without one of its chunks: with fill_value null it
    raises, naming the key; with a fill_value the chunk is filled."""
    db = orbax_read.OcdbtReader(_save(tmp_path / "ck", {"w": np.arange(6, dtype=np.float32)}))
    items = dict(db.items())
    meta = json.loads(db.value(items[b"w/.zarray"]))

    class Dropped:
        root = db.root

        def __init__(self, m):
            self.m = m

        def items(self):
            return [(k, json.dumps(self.m).encode() if k == b"w/.zarray" else v)
                    for k, v in items.items() if k != b"w/0"]

        def value(self, v):
            return db.value(v) if not isinstance(v, bytes) else v

    with pytest.raises(orbax_read.OrbaxFormatError, match="w/0: chunk missing"):
        orbax_read.read_arrays(Dropped(meta), ["w"])
    out = orbax_read.read_arrays(Dropped(dict(meta, fill_value=1.5)), ["w"])["w"]
    assert torch.equal(out, torch.full((6,), 1.5))


def _tiny_jax_state(extra=()):
    """The tiny fp32 flagship's initial JAX TrainState (JAX's init)."""
    from test_torch_quality import overrides

    from emernerf_tpu.flagship import build_flagship as jax_build_flagship
    from emernerf_tpu.train.step import init_train_state as jax_init_train_state

    cfg, dataset, jmodel, jprops, step_cfg = jax_build_flagship(
        tiny=True, overrides=overrides(10) + list(extra))
    scene = dataset.scene_tensors()
    from emernerf_tpu.data.scene import sample_pixel_batch

    pb = sample_pixel_batch(scene, jax.random.PRNGKey(0), cfg.data.ray_batch_size,
                            use_timestamps=True)
    return jax_init_train_state(jmodel, jprops, step_cfg, jax.random.PRNGKey(1), pb)


def _port_state(extra=()):
    from test_torch_quality import overrides

    _, _, model, props, _ = build_flagship(tiny=True, overrides=overrides(10) + list(extra),
                                           device="cpu")
    return init_train_state(model, props)


def _tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, pm in enumerate(state.prop_models):
        out.update({f"prop{i}.{k}": v for k, v in pm.state_dict().items()})
    for tag, s in (("opt", state.opt_state), ("prop_opt", state.prop_opt_state)):
        out.update({f"{tag}.mu{i}": m for i, m in enumerate(s.mu)})
        out.update({f"{tag}.nu{i}": m for i, m in enumerate(s.nu)})
        out[f"{tag}.count"] = torch.tensor(s.count)
    out["step"] = torch.tensor(state.step)
    return out


def _load_restored(state, restored):
    """The converter's route from orbax's restore (the route before the
    reader): the reference the reader's route must equal."""
    r = _orbax_tree(restored)
    adam = next(s for s in r["opt_state"] if s is not None)
    prop_adam = next(s for s in r["prop_opt_state"] if s is not None)
    return load_jax_train_state(state, r["params"], r["prop_params"],
                                (adam["count"], adam["mu"], adam["nu"]),
                                (prop_adam["count"], prop_adam["mu"], prop_adam["nu"]),
                                int(r["step"]))


def _assert_same_states(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k


@pytest.fixture
def bf16_moments(monkeypatch):
    monkeypatch.setattr(optim, "_BF16_MOMENT_MIN_ELEMS", SMALL_BF16_MOMENTS)
    monkeypatch.setattr(jax_optim, "_BF16_MOMENT_MIN_ELEMS", SMALL_BF16_MOMENTS)


def test_tiny_train_state_reads_bit_for_bit_and_loads(tmp_path, bf16_moments):
    jstate = _tiny_jax_state()
    jstate = jstate.replace(step=jnp.asarray(37, jnp.int32))
    path = jax_save_checkpoint(str(tmp_path), jstate)
    assert orbax_read.is_orbax_checkpoint(path)
    restored = _restore(path)
    ours = orbax_read.read_tree(path)
    assert_bit_equal(ours, restored)
    assert any(v is not None and v.dtype == torch.bfloat16 for _, v in _walk(ours))
    state = load_checkpoint(path, _port_state())
    assert state.step == 37
    _assert_same_states(state, _load_restored(_port_state(), restored))


_ZERO_WRITER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = [{repo!r}, {tests!r}]
import jax, numpy as np
import emernerf_tpu.train.optim as jax_optim
jax_optim._BF16_MOMENT_MIN_ELEMS = {small}
from jax.sharding import Mesh
from emernerf_tpu.parallel.spmd import SpmdConfig, shard_state
from emernerf_tpu.train.checkpoints import load_checkpoint, save_checkpoint
from test_torch_orbax import _tiny_jax_state
assert len(jax.devices()) == 2
state = _tiny_jax_state()
mesh = Mesh(np.array(jax.devices()), ("data",))
state = shard_state(state, mesh, SpmdConfig(zero=True, zero_min_elems={small}))
sharded = [x.sharding.spec for x in jax.tree.leaves(state.opt_state)]
assert any(len(s) and s[0] == "data" for s in sharded), sharded
print(save_checkpoint({out!r}, state))
import orbax.checkpoint as ocp
direct = os.path.join({out!r}, "direct", "checkpoint_00000")
ckptr = ocp.StandardCheckpointer()
ckptr.save(direct, state)
ckptr.wait_until_finished()
print(direct)
"""


def _assert_zero_rows(path, whole, rank, monkeypatch):
    """``path`` loaded into rank ``rank`` of a 2-rank ZeRO state: each
    routed moment is that rank's rows of ``whole``'s, the rest equal."""
    from emernerf_torch.parallel import mesh
    from emernerf_torch.parallel.spmd import SpmdConfig, moment_rows, shard_state

    group = object()
    monkeypatch.setattr(mesh, "rank_and_size", lambda g: (rank, 2) if g is group else (0, 1))
    state = shard_state(_port_state(), SpmdConfig(zero=True, zero_min_elems=SMALL_BF16_MOMENTS),
                        group)
    assert any(state.zero.model.big)
    load_checkpoint(path, state)
    for ours, theirs, route in ((state.opt_state, whole.opt_state, state.zero.model),
                                (state.prop_opt_state, whole.prop_opt_state, state.zero.prop)):
        n = len(ours.mu)
        for i, (m, w) in enumerate(zip(ours.mu + ours.nu, theirs.mu + theirs.nu)):
            assert torch.equal(m, moment_rows(w, route, i % n, group)), (rank, i)
        assert ours.count == theirs.count
    for a, b in zip(state.params, whole.params):
        assert torch.equal(a, b)


def test_zero_layout_of_two_devices_reads_bit_for_bit(tmp_path, bf16_moments, monkeypatch):
    """The JAX trainer's explicit ZeRO state (big moments sharded on dim 0
    over 2 devices) written in a subprocess, twice: by the JAX package's
    ``save_checkpoint``, which gathers the state to the host first (whole
    arrays), and by orbax straight from the sharded arrays (the sharded
    moments, and some replicated leaves, in 2 chunks, which the reader
    assembles).  Each equals the restore of this 1-device process bit for
    bit and loads into the port at 1 rank as the converter takes that
    restore, and into each of 2 ranks of the port's ZeRO layout (emulated in
    this process) as that rank's rows of the 1-rank load."""
    code = _ZERO_WRITER.format(repo=REPO, tests=HERE, small=SMALL_BF16_MOMENTS,
                               out=str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    gathered, direct = r.stdout.strip().splitlines()[-2:]
    jstate = _tiny_jax_state()
    for path, chunked in ((gathered, False), (direct, True)):
        keys = [k for k, _ in orbax_read.OcdbtReader(path).items()]
        two = {k.split(b"/")[0] for k in keys if k.endswith(b"/1.0")}
        assert bool(two) == chunked, two
        assert not chunked or any(b".mu." in k for k in two), two
        restored = ocp.StandardCheckpointer().restore(
            path, jax.tree.map(ocp.utils.to_shape_dtype_struct, jstate))
        assert_bit_equal(orbax_read.read_tree(path), restored)
        state = load_checkpoint(path, _port_state())
        _assert_same_states(state, _load_restored(_port_state(), restored))
        for rank in range(2):
            _assert_zero_rows(path, state, rank, monkeypatch)


def test_a_flipped_byte_in_a_node_raises_naming_the_file(tmp_path):
    path = _save(tmp_path / "ck", {"w": np.arange(300, dtype=np.float32),
                                   "v": np.ones(3, np.float32)})
    nodes = [os.path.join(path, "d", f) for f in os.listdir(os.path.join(path, "d"))]
    assert nodes
    for node in nodes:
        data = bytearray(open(node, "rb").read())
        for pos in (2, 20, len(data) // 2, len(data) - 2):
            bad = bytearray(data)
            bad[pos] ^= 0x10
            open(node, "wb").write(bad)
            with pytest.raises(orbax_read.OrbaxFormatError, match=os.path.basename(node)):
                orbax_read.read_tree(path)
        open(node, "wb").write(data)
    assert_bit_equal(orbax_read.read_tree(path), _restore(path))


def test_without_the_native_decoder_loading_raises(tmp_path, monkeypatch):
    path = jax_save_checkpoint(str(tmp_path), _tiny_jax_state())
    monkeypatch.setattr(native_zstd, "_lib", None)
    monkeypatch.setattr(native_zstd, "_tried", True)
    with pytest.raises(RuntimeError, match="native zstd decoder"):
        load_checkpoint(path, _port_state())


# ---------------------------------------------------------------- fixture
def _fixture_meta():
    with open(os.path.join(FIXTURE, "expected.json")) as f:
        return json.load(f)


def _fixture_path():
    return os.path.join(FIXTURE, f"checkpoint_{FIXTURE_STEP:05d}")


def leaf_summary(tree):
    """Each leaf's shape, dtype and sum (exact, ``math.fsum`` of its float64
    values), by its dotted key path."""
    out = {}
    for k, v in _walk(tree):
        if v is None:
            continue
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        out[".".join(k)] = {"shape": list(t.shape), "dtype": _dtype_name(v),
                            "sum": math.fsum(t.double().reshape(-1).numpy())}
    return out


def test_committed_fixture_matches_orbax_restore_and_its_record():
    meta = _fixture_meta()
    path = _fixture_path()
    ours = orbax_read.read_tree(path)
    assert_bit_equal(ours, _restore(path))
    assert leaf_summary(ours) == meta["leaves"]
    assert int(ours["step"]) == meta["step"] == FIXTURE_STEP
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(FIXTURE) for f in fs)
    assert size <= 4 << 20, size


@contextlib.contextmanager
def tiny_flow_spec():
    """The tiny flagship's flow grid in ``builders.flow_spec``'s place, for
    a CLI run of the tiny flagship."""
    saved = port_builders.flow_spec
    port_builders.flow_spec = flagship.tiny_flow_spec
    try:
        yield
    finally:
        port_builders.flow_spec = saved


def fixture_argv(out_root, run_name, *flags):
    """The CLI's arguments for the fixture's config (the flagship and tiny
    dotlists and the fixture's overrides) on ``--device cpu``."""
    return (["--device", "cpu", "--output_root", str(out_root), "--project", "p",
             "--run_name", run_name, *flags] + list(flagship._FLAGSHIP_DOTLIST)
            + list(flagship._TINY_DOTLIST) + list(_fixture_meta()["overrides"])
            + ["render.render_low_res=false", "render.render_full=false",
               "logging.saveckpt_freq=1000000"])


def test_cli_eval_only_on_the_fixture_meets_jax(tmp_path):
    """The held-out PSNR and SSIM the CLI writes, and the evaluated model's
    held-out lidar depth RMSE, against JAX's (``expected.json``)."""
    from emernerf_torch.train_emernerf import main

    meta = _fixture_meta()
    with tiny_flow_spec():
        trainer = main(fixture_argv(tmp_path, "ev", "--eval_only",
                                    f"resume_from={_fixture_path()}"))
    run = tmp_path / "p" / "ev"
    got = json.load(open(run / f"metrics_test_{FIXTURE_STEP}.json"))
    want = meta["held_out"]
    depth = trainer_depth_rmse(trainer)
    print(f"port {got}, depth_rmse {depth!r}\nJAX {want}")
    assert abs(got["psnr"] - want["psnr"]) <= PSNR_DB, (got, want)
    assert abs(got["ssim"] - want["ssim"]) <= SSIM_ABS, (got, want)
    assert abs(depth - want["depth_rmse"]) <= DEPTH_RTOL * want["depth_rmse"], (depth, want)


def trainer_depth_rmse(trainer):
    """The evaluated model's held-out lidar depth RMSE, taken as
    ``test_torch_quality.py:_held_out`` takes it."""
    return held_out_depth_rmse(
        trainer.dataset, lambda rays: trainer.renderer.render_rays_chunked(rays, is_lidar=True))


def test_auto_resume_takes_the_newest_jax_checkpoint(tmp_path):
    """A JAX run directory holding two orbax checkpoints (and an orbax
    temporary): ``latest_checkpoint`` takes the newest, and the CLI's
    ``--auto_resume`` resumes from it and trains on."""
    from emernerf_torch.train_emernerf import main

    run = tmp_path / "p" / "ar"
    run.mkdir(parents=True)
    shutil.copytree(_fixture_path(), run / "checkpoint_00100")
    shutil.copytree(_fixture_path(), run / "checkpoint_00040")
    shutil.copytree(_fixture_path(), run / "checkpoint_00200.orbax-checkpoint-tmp-1")
    assert latest_checkpoint(str(run)) == str(run / "checkpoint_00100")
    with tiny_flow_spec():
        trainer = main(fixture_argv(tmp_path, "ar", "--auto_resume", "optim.num_iters=102"))
    step = trainer.state.step
    assert trainer.start_step == FIXTURE_STEP < step
    assert os.path.isfile(run / f"checkpoint_{step:05d}")  # the port's own, after it
    assert os.path.isfile(run / f"metrics_test_{step}.json")


# ------------------------------------------------------------ the writer
def write_fixture(root: str = FIXTURE, iters: int = FIXTURE_STEP, profile=None, widen=None):
    """Train the tiny fp32 flagship of ``test_torch_quality.py`` ``iters``
    JAX iterations (its batches, schedule and keys), save the state with
    the JAX package's checkpointer and record JAX's held-out metrics and
    each leaf's shape, dtype and float64 sum.  ``profile`` (a
    ``flagship.Profile``) and ``widen`` (its sample counts): another
    profile's tiny flagship, recorded in ``expected.json`` as its config
    file (relative to the repository) and dotlist."""
    from test_torch_quality import WIDE, Run, overrides

    from emernerf_tpu.train.checkpoints import load_checkpoint as jax_load
    from emernerf_tpu.train.step import build_train_step as jax_build_train_step

    widen = WIDE if widen is None else widen
    run = Run(iters, profile or flagship.DEFAULT_PROFILE, widen)
    jstate = run.jax_state()
    jstep = jax_build_train_step(run.jmodel, run.jprops, run.step_cfg)
    for it in range(iters):
        pb, lb, rg, full = run.iteration(it)
        jstate, _ = jstep(jstate, pb, lb, jax.random.PRNGKey(10_000 + it), pixel_rg=rg,
                          lidar_rg=rg, lidar_full=full)
    held_out = run.held_out_jax(jstate)
    if os.path.isdir(root):
        shutil.rmtree(root)
    os.makedirs(root)
    path = jax_save_checkpoint(root, jstate)
    restored = _orbax_tree(jax_load(path, jstate))
    meta = {"overrides": overrides(iters, widen), "step": int(restored["step"]),
            "held_out": {k: float(v) for k, v in held_out.items()},
            "leaves": leaf_summary(restored)}
    if profile is not None:
        meta["profile"] = {"config_file": profile.config_file and os.path.relpath(
            profile.config_file, REPO), "overrides": list(profile.overrides)}
    with open(os.path.join(root, "expected.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    print(path, meta["held_out"])


def full_width(root: str):
    """The full-width flagship's initial JAX TrainState (the JAX package's
    initializer and checkpointer, about 2.5 GB) written under ``root``, read
    by the port (seconds, MB/s) and held to orbax's restore leaf by leaf, bit
    for bit."""
    import gc
    import time

    from emernerf_tpu.data.scene import sample_pixel_batch
    from emernerf_tpu.flagship import build_flagship as jax_build_flagship
    from emernerf_tpu.train.step import init_train_state as jax_init_train_state

    cfg, dataset, jmodel, jprops, step_cfg = jax_build_flagship(tiny=False)
    pb = sample_pixel_batch(dataset.scene_tensors(), jax.random.PRNGKey(0),
                            cfg.data.ray_batch_size, use_timestamps=True)
    t0 = time.perf_counter()
    state = jax.jit(lambda k: jax_init_train_state(jmodel, jprops, step_cfg, k, pb))(
        jax.random.PRNGKey(1))
    path = jax_save_checkpoint(root, state)
    print(f"JAX: initialized and saved {path} in {time.perf_counter() - t0:.1f} s")
    del state
    gc.collect()
    t0 = time.perf_counter()
    ours = orbax_read.read_tree(path)
    secs = time.perf_counter() - t0
    stats = orbax_read.last_read
    disk = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
    print(f"port: {stats['arrays']} arrays, {stats['decoded_bytes']} bytes decoded from "
          f"{disk} on disk in {secs:.2f} s: {stats['decoded_bytes'] / secs / 1e6:.1f} MB/s "
          f"decoded, {disk / secs / 1e6:.1f} MB/s from disk ({os.cpu_count()} CPU threads "
          f"of the host, warm: the files were just written)")
    theirs = _restore(path)
    assert_bit_equal(ours, theirs)
    n = sum(v.numel() for _, v in _walk(ours) if v is not None)
    print(f"every leaf bit for bit with orbax's restore: {n} elements")


if __name__ == "__main__":
    import argparse

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_platforms", "cpu")
    parser = argparse.ArgumentParser(description="the fixture writer and the full-width check")
    parser.add_argument("--write-fixture", action="store_true",
                        help=f"write {os.path.relpath(FIXTURE, REPO)} (JAX, ~1.5 min)")
    parser.add_argument("--full-width", metavar="DIR",
                        help="write the full-width initial state under DIR and read it back")
    args = parser.parse_args()
    sys.path.insert(0, HERE)
    if args.write_fixture:
        write_fixture()
    if args.full_width:
        full_width(args.full_width)
    if not (args.write_fixture or args.full_width):
        parser.print_usage()
