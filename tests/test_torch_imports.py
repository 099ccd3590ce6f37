"""Package boundary of the port: emernerf_torch never imports jax, flax or
optax, and its flagship config is the JAX package's."""

import os
import subprocess
import sys
import textwrap

import pytest

from emernerf_tpu.flagship import flagship_config as jax_flagship_config
from emernerf_torch.flagship import flagship_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_every_module_imports_without_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax"):
            sys.modules[name] = None  # any import of them raises
        import emernerf_torch
        names = [m.name for m in pkgutil.walk_packages(emernerf_torch.__path__, "emernerf_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every module was walked


@pytest.mark.parametrize("tiny", [True, False])
def test_flagship_config_equals_jax(tiny):
    assert flagship_config(tiny=tiny).to_dict() == jax_flagship_config(tiny=tiny).to_dict()
