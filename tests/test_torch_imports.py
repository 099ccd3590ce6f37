"""Package boundary of the port: emernerf_torch never imports jax, flax,
optax, the JAX package emernerf_tpu or the repository's perf/ scripts, its
own copies of the JAX package's framework-free modules (config, synthetic
scene, metrics) agree with the originals, its flagship config is the JAX
package's, and its entry points run on the card unless asked for the CPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from emernerf_tpu import config as jax_config
from emernerf_tpu import flagship as jax_flagship
from emernerf_tpu.data import synthetic as jax_synthetic
from emernerf_tpu.eval import metrics as jax_metrics
from emernerf_torch import config, flagship
from emernerf_torch.data import synthetic
from emernerf_torch.eval import metrics
from emernerf_torch.flagship import REFERENCE_HASH, flagship_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# and the repository's perf/ scripts (the TPU probes the port counterparts)
_BLOCKED = ("jax", "jaxlib", "flax", "optax", "emernerf_tpu", "perf")


def test_every_module_imports_without_jax():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        blocked = {_BLOCKED!r}
        for name in blocked:
            sys.modules[name] = None  # any import of them raises
        import emernerf_torch
        names = [m.name for m in pkgutil.walk_packages(emernerf_torch.__path__, "emernerf_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = [m for m in sys.modules if m.split(".")[0] in blocked
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print(" ".join(names))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    walked = set(out.stdout.split())
    assert len(walked) >= 20  # every module was walked
    assert {"emernerf_torch.ops.gather_scatter", "emernerf_torch.perf.pallas_experiments",
            "emernerf_torch.perf.bench_scatter_alts", "emernerf_torch.train.checkpoints",
            "emernerf_torch.train_emernerf", "emernerf_torch.utils.logging"} <= walked


@pytest.mark.parametrize("tiny", [True, False])
def test_flagship_config_equals_jax(tiny):
    assert flagship_config(tiny=tiny).to_dict() == jax_flagship.flagship_config(tiny=tiny).to_dict()


def jax_profile_config(tiny, overrides=()):
    """The JAX flagship config of the reference-hash profile: the JAX
    package's flagship dotlist merged over the defaults and the profile's
    config file, as the CLI merges them."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_flagship, "load_config",
                  lambda path: jax_config.load_config(path, REFERENCE_HASH.config_file))
        return jax_flagship.flagship_config(tiny, list(REFERENCE_HASH.overrides) + list(overrides))


@pytest.mark.parametrize("profile", ["default", "flagship", "reference_hash", "reference_hash_tiny"])
def test_config_copy_equals_jax(profile):
    dot = ["data.dataset=synthetic", "nerf.model.head.enable_flow_branch=true"]
    cases = {
        "default": (None, []),
        "flagship": (None, dot),
        "reference_hash": (REFERENCE_HASH.config_file, dot + list(REFERENCE_HASH.overrides)),
    }
    if profile == "reference_hash_tiny":
        ours, ref = flagship_config(tiny=True, profile=REFERENCE_HASH), jax_profile_config(True)
        assert ours.nerf.model.grid_backend == "hash" and ours.nerf.model.fuse_flow_grid is False
    else:
        cfile, dots = cases[profile]
        ours = config.load_config(flagship.DEFAULT_CONFIG, cfile, dots)
        ref = jax_config.load_config(jax_flagship.DEFAULT_CONFIG, cfile, dots)
    assert ours.to_dict() == ref.to_dict()
    assert ours.to_yaml() == ref.to_yaml()


def test_synthetic_scene_copy_equals_jax():
    cfg = flagship_config()
    syn = cfg.data.synthetic
    kw = dict(num_frames=syn.num_frames, num_cams=cfg.data.pixel_source.num_cams,
              hw=(syn.image_height, syn.image_width), dynamic=syn.dynamic)
    ours, ref = synthetic.make_synthetic_scene(**kw), jax_synthetic.make_synthetic_scene(**kw)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(ref[k]), err_msg=k)


def test_metrics_copy_equals_jax():
    rng = np.random.default_rng(0)
    a, b = rng.uniform(0, 1, (2, 24, 32, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (24, 32)) > 0.5
    assert metrics.compute_psnr(a, b) == jax_metrics.compute_psnr(a, b)
    ours, ref = metrics.compute_ssim(a, b, full=True), jax_metrics.compute_ssim(a, b, full=True)
    assert ours[0] == ref[0]
    np.testing.assert_array_equal(ours[1], ref[1])
    assert metrics.compute_psnr(a[mask], b[mask]) == jax_metrics.compute_psnr(a[mask], b[mask])
    depth, gt = rng.uniform(0, 50, (2, 500))
    gt[::3] = 0.0  # rays without a return
    assert (metrics.compute_valid_depth_rmse(depth, gt)
            == jax_metrics.compute_valid_depth_rmse(depth, gt))
    flow, labels = rng.normal(size=(2, 300, 3))
    assert (metrics.compute_scene_flow_metrics(flow, labels)
            == jax_metrics.compute_scene_flow_metrics(flow, labels))
    names = sorted(n for n in dir(jax_metrics) if n.startswith("compute_"))
    assert names == sorted(n for n in dir(metrics) if n.startswith("compute_"))
