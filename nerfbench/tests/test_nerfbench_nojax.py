"""No module a run loads is JAX's or the JAX package's, and the reference
loads nothing of the program; each checked in a fresh process, by the
top-level name of every module in ``sys.modules``, compared whole."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _top_names(code: str):
    script = ("import sys, json\nsys.path.insert(0, %r)\n%s\n"
              "print(json.dumps(sorted({m.split('.')[0] for m in list(sys.modules)})))"
              % (ROOT, code))
    p = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def _benchmark_modules():
    out = []
    for base, _, files in os.walk(os.path.join(ROOT, "nerfbench")):
        if "tests" in base.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(base, f), os.path.join(ROOT, "nerfbench")))
    return sorted(out)


def test_a_run_loads_no_jax():
    """run.py's modules, every driver, metric reader and reference module,
    and the program they drive."""
    code = ("import runpy, importlib\n"
            "from nerfbench import harness\n"
            "runpy.run_path(%r, run_name='nerfbench_run')\n"
            "for rel in %r:\n"
            "    parts = rel.split('/')\n"
            "    harness.load_module(*parts)\n"
            "import emernerf_torch.train.trainer, emernerf_torch.eval.renderer\n"
            % (os.path.join(ROOT, "nerfbench", "run.py"), _benchmark_modules()))
    names = _top_names(code)
    assert "emernerf_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "emernerf_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    mods = [m for m in _benchmark_modules()
            if m.startswith(("reference/", "counts/")) or m in ("weights.py", "harness.py")]
    code = ("from nerfbench import harness\n"
            "for rel in %r:\n"
            "    harness.load_module(*rel.split('/'))\n"
            "import nerfbench.reference.compare, nerfbench.reference.plain.builders\n"
            "import nerfbench.reference.plain.train.step, nerfbench.reference.plain.render.renderer\n"
            % mods)
    names = _top_names(code)
    assert not names & {"emernerf_torch", "jax", "jaxlib", "flax", "emernerf_tpu"}
