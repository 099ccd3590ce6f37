"""One training step of the flagship at its level counts and sample counts,
from a common state past the line-of-sight loss's start, in both packages
on the CPU.

The port's full-width range RMSE rose after step 2,000 on the card where the
JAX record's fell (ROADMAP queue 3); every earlier common-state comparison
ran the tiny flagship.  Here the flagship of ``emernerf_tpu/flagship.py:27``
(not tiny: 10 static and 10 fused dynamic-and-flow levels of 4 + 4
features, 8 + 8 proposal levels, proposal samples (128, 64), 64 final
samples, the default synthetic scene) runs with ``stagedl16``'s settings
(top-K 32 pixel and 16 lidar samples, the lidar unpruned from 90% of
``optim.num_iters=2500``) in fp32, from the same parameters (JAX's
initializer, tables scaled as ``test_torch_train_step.py`` scales them,
loaded through ``convert.load_jax_train_state``) with the step counter at
2,100 (line of sight live, lidar pruned to 16) and 2,300 (line of sight
live, lidar unpruned), on one pixel and one lidar batch with the draws JAX
drew.  Held, at ``test_torch_train_step.py``'s tolerances: every loss term
(``line_of_sight_loss`` among them) and ``range_rmse``, the line-of-sight
weight and ``lidar_full_at`` of both packages, and the gradient of every
leaf that each branch hands to Adam.

The top-K selections (the Gumbel top-K of samples, the temporal
aggregation's K most dynamic samples) are injected as the draws are: at the
full sample counts a ray's K-th and (K+1)-th scores can tie to within the
two packages' rounding (one ray of 512 in the aggregation at step 2,100,
7.8e-6 apart), or one package's sample can sit across a brick face from
the other's (below: one ray of 8,192, its density 1.6% apart), and a
selection that flips there moves the flow MLP's gradient by 4% of its
largest element.  So every JAX ``jax.lax.top_k`` is recorded with its
operand; each of the port's selections is paired with the JAX call of the
same shape, K and nearest operand; where the two select different samples,
the test asserts that the moved samples' scores agree between the packages
within 5e-2 (relative; the grid-fed leaves' allowance below) and the port
takes JAX's selection.

The leaves that read the finest grid cells take a wider atol, 5e-2 x the
leaf's largest |grad|: the static and the fused dynamic-and-flow tables,
the first layers of the static and dynamic MLPs, and the flow MLP.  At
8,192 cells a side a cell is about a centimetre wide, each brick keeps its
own copy of its corners (so the encoding jumps at a brick's face, by up to
the tables' U(+-0.2)), and the flow-warped queries of the temporal
aggregation sit wherever the flow puts them: the two packages' sample
positions differ by rounding, and a point on the other side of a face
changes its features, its flow and the cycle loss there.  The port
against itself shows the same spread (the script's ``--floor``: the ray
origins one ulp apart): at 8,192 + 8,192 rays it moves these leaves by up
to 2.3% of their largest element, where JAX is up to 6.9% away (the lidar
branch's flow MLP at step 2,100; 1.7% at 2,300; 4.7% at 2,048 rays).
Every other leaf (the heads, the proposal nets) is held at
``test_torch_train_step.py``'s tolerances.

With the fused table left at its initializer's U(+-1e-4)
(``--smooth-dynamic``) the whole step's lidar flow-MLP gradient stayed 2-5%
from JAX's where the pixel branch's agreed to 1e-5.  That was two things,
neither a fault of the port:
- the count-0 Adam sign step.  The lidar branch runs on the parameters the
  pixel branch's update moved; both Adam states are at count 0 with eps
  1e-15, so that update moves every touched element by +-lr whatever the
  size of its gradient, and where a rounding-level ``g + 1e-5 p`` has
  opposite signs in the two packages (173 of the fused table's 8,847,360
  elements at 2,048 rays) the lidar branch reads parameters 2 lr apart.
  So the lidar branch is also held alone, from the parameters JAX's pixel
  update returned (``jax_taps`` hands them over):
  ``test_lidar_branch_from_jax_updated_params_matches_jax``;
- the aggregation path.  The lidar branch's flow MLP learns only through
  the temporal aggregation: the fused grid read at the flow-warped points,
  whose position gradient jumps at every cell face of the fine levels,
  and the samples' flow encoding, which jumps at a brick's face.  The
  pixel branch's does too, but its cycle loss reaches the flow MLP
  directly and that smooth share hid the rest: with the cycle loss off
  (``tests/test_torch_full_width_cycle_off.py``) the pixel branch's flow
  MLP is 2.2e-2 to 4.0e-2 of each leaf's largest from JAX's at 2,048 rays,
  inside the port's own one-ulp spread there (2.8e-2 to 4.7e-2).
The residual, named by ``tests/full_width_flow_mlp.py --residual`` (2,048
+ 2,048 rays,
step 2,300, ``--smooth-dynamic``, the lidar branch alone from the
parameters JAX's ran on): the port is 1.0e-3 to 2.4e-3 of each flow_mlp
leaf's largest from JAX.  13 of the 65,536 warped points lie in another
cell at some level in the two packages (their positions at most 8 ulp
apart); JAX's position cotangent injected at the warped points leaves
``flow_mlp.layers.0.weight`` 9.9e-4 apart and the other leaves within
7e-7.  The rest is that weight's input: 10 of the 131,072 samples straddle
a brick face (their flow encodings up to 6.2e-4 apart, the rest within
1.3e-6), and JAX's flow encoding of the samples injected as well leaves
every leaf within 4e-7.  A float64 evaluation of that path (the flow MLP,
the warp, the contraction and the grid read, on the port's fp32 inputs)
lands 2.3e-2 to 3.2e-2 from the port and 2.4e-2 to 3.2e-2 from JAX: both
packages' fp32 positions round to the same cell at all but 13 points,
float64's lie across a face from the port's at 33.  So it is rounding at
the cell and brick faces, bound by float64's distance from either
package; the lidar branch alone is 1.0e-3 to 2.4e-3 from JAX, inside the
port's own one-ulp spread of 2.8e-3 to 3.8e-3.  At this file's size (256
+ 256 rays, the scaled tables; ``tests/full_width_flow_mlp.py --rays 256
[--cycle-off]``) each branch run alone from the parameters JAX's ran on
holds every flow_mlp leaf, x the leaf's largest |grad|: the lidar branch's
at ``LIDAR_FLOW_MLP_ATOL`` = 1.5e-2 (measured 5.1e-3 to 8.7e-3, and 6.0e-3
to 1.0e-2 with the cycle loss off; the port's own one-ulp spread 2.1e-3 to
1.5e-2), the pixel branch's with the cycle loss off at ``FLOW_MLP_ATOL`` =
2.5e-2 (measured 3.3e-3 to 1.8e-2).

The test takes 256 + 256 rays at step 2,300 (the JAX step compiles for
about a minute for each lidar schedule); as a script
(``PYTHONPATH=.:tests python tests/test_torch_full_width_step.py --rays
8192 [--floor]``) it takes one full batch of 8,192 + 8,192 rays at both
steps and prints every loss and each branch's gradient leaves outside the
tolerance.  ``tests/full_width_flow_mlp.py`` runs each branch alone from
the parameters JAX's ran on and prints each flow_mlp leaf's distance from
JAX beside the port's own one-ulp spread, or (``--residual``) takes the
lidar branch's flow-MLP gradient apart as above.
"""

import contextlib
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import (
    GRAD_ATOL,
    GRAD_RTOL,
    LIDAR_GRAD_ATOL_AFTER_LR_1E2,
    LOSS_RTOL,
    _assert_grads_close,
    _assert_losses_close,
    _named,
    _scale_tables,
    _to_torch,
)

import emernerf_tpu.train.step as jax_step_mod
import emernerf_torch.models.fields as fields_mod
import emernerf_torch.render.renderer as renderer_mod
import emernerf_torch.train.step as step_mod
from emernerf_torch.convert import load_jax_params, load_jax_train_state
from emernerf_torch.flagship import build_flagship
from emernerf_torch.train.state import init_train_state
from emernerf_torch.train.step import build_train_step, lidar_full_at, los_decay_weight
from emernerf_tpu.data.scene import sample_lidar_batch as jax_sample_lidar
from emernerf_tpu.data.scene import sample_pixel_batch as jax_sample_pixel
from emernerf_tpu.flagship import build_flagship as jax_build_flagship
from emernerf_tpu.train.step import _los_decay_weight as jax_los_decay_weight
from emernerf_tpu.train.step import build_train_step as jax_build_train_step
from emernerf_tpu.train.step import init_train_state as jax_init_train_state
from emernerf_tpu.train.step import lidar_full_at as jax_lidar_full_at
from jax_draw_tap import Tap, iteration_draws, uniform_tap

STAGEDL16 = ["nerf.sampling.sample_topk=32", "nerf.sampling.sample_topk_temp=0.3",
             "nerf.sampling.lidar_sample_topk=16", "nerf.sampling.lidar_topk_until=0.9"]
# the widest tables this host's shared memory takes (module docstring)
TABLES = ["nerf.model.xyz_encoder.log2_hashmap_size=16",
          "nerf.model.dynamic_xyz_encoder.log2_hashmap_size=14",
          "nerf.propnet.xyz_encoder.lgo2_hashmap_size_per_prop=[16,16]"]
FP32 = ["nerf.model.table_dtype=float32", "nerf.model.mlp_dtype=float32"]
STEPS = (2100, 2300)  # line of sight live; the lidar pruned to 16, then unpruned
RAYS = 256
# a selection may differ only where the moved samples' scores agree between
# the packages to this relative precision (module docstring)
TIE = 5e-2
# the leaves that read the finest grid cells, and their atol x the leaf's
# largest |grad| (module docstring)
GRID_FED = ("xyz_table", "base_mlp.layers.0.", "dynflow_table", "dynamic_base_mlp.layers.0.",
            "flow_mlp.")
GRID_FED_ATOL = 5e-2
# every flow_mlp leaf of a branch run alone from the parameters JAX's ran on,
# x the leaf's largest |grad| (module docstring): the pixel branch's
# (measured at most 1.8e-2, with the cycle loss off) and the lidar branch's
# (measured at most 1.0e-2; the port's own one-ulp spread up to 1.5e-2)
FLOW_MLP_ATOL = 2.5e-2
LIDAR_FLOW_MLP_ATOL = 1.5e-2


def overrides(rays: int = RAYS):
    return (STAGEDL16 + TABLES + FP32
            + ["optim.num_iters=2500", f"data.ray_batch_size={rays}"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Selections:
    """JAX's top-K calls of one step, (operand, indices) in trace order, and
    the port's selections paired with them (module docstring)."""

    def __init__(self, records, tie: float = TIE):
        self.tie = tie
        self.records = [(np.asarray(x), np.asarray(i)) for x, i in records]
        self.used = [False] * len(self.records)
        self.paired = 0
        self.ties = []  # (site, ray, K-th gap, operand difference) where the two differ
        self.chosen = []  # (site, the indices taken)

    def choose(self, scores: torch.Tensor, k: int, site: str) -> torch.Tensor:
        s = scores.detach().numpy()
        cands = [j for j, (x, i) in enumerate(self.records)
                 if not self.used[j] and x.shape == s.shape and i.shape[1] == k]
        assert cands, (site, s.shape, k)
        j = min(cands, key=lambda j: float(np.max(np.abs(self.records[j][0] - s))))
        self.used[j] = True
        self.paired += 1
        x, jidx = self.records[j]
        own = np.argsort(-s, axis=1, kind="stable")[:, :k]
        for r in np.nonzero((np.sort(own, 1) != np.sort(jidx, 1)).any(1))[0]:
            moved = np.setxor1d(own[r], jidx[r])
            diff = float(np.max(np.abs(x[r, moved] - s[r, moved]) / np.abs(x[r, moved])))
            kth = np.sort(x[r])[::-1][k - 1:k + 1]
            gap = float((kth[0] - kth[1]) / abs(kth[0]))
            assert diff <= self.tie, (site, r, diff, gap)
            self.ties.append((site, int(r), gap, diff))
        idx = torch.from_numpy(jidx.astype(np.int64))
        self.chosen.append((site, idx))
        return idx

    def patch(self, m):
        """The port's two selection sites take their indices from here."""
        sel = self

        def selecting(fn, site, k_of):
            def wrapped(*args, **kw):
                k = k_of(*args, **kw)
                orig = torch.sort

                def sort(x, *a, descending=False, stable=False, **kw2):
                    if descending and stable:
                        return x, sel.choose(x, k, site)
                    return orig(x, *a, descending=descending, stable=stable, **kw2)

                with pytest.MonkeyPatch.context() as inner:
                    inner.setattr(torch, "sort", sort)
                    return fn(*args, **kw)
            return wrapped

        m.setattr(renderer_mod, "topk_sample_select",
                  selecting(renderer_mod.topk_sample_select, "sample top-K",
                            lambda prop_fn, ts, te, k, *a, **kw: k))
        m.setattr(fields_mod.RadianceField, "_topk_aggregation",
                  selecting(fields_mod.RadianceField._topk_aggregation, "aggregation",
                            lambda self, *a, **kw: a[6] if len(a) > 6 else kw["k"]))


class FullWidth:
    """Both packages' full-width flagship at one common state, and JAX's
    jitted step built inside the taps of :func:`jax_taps`."""

    def __init__(self, taps, rays: int = RAYS, unscaled=(), cycle_coef=None):
        """``unscaled``: model tables left at JAX's initializer's scale;
        ``cycle_coef``: the cycle loss's coefficient in both step configs
        (None: the config's)."""
        self.draws, self.grads, self.updated, self.topk = taps
        ov = overrides(rays)
        cfg, dataset, jmodel, jprops, self.step_cfg = jax_build_flagship(tiny=False, overrides=ov)
        if cycle_coef is not None:
            self.step_cfg = dataclasses.replace(self.step_cfg, cycle_coef=cycle_coef)
        self.scene, self.r = dataset.scene_tensors(), cfg.data.ray_batch_size
        pb = jax_sample_pixel(self.scene, jax.random.PRNGKey(3), self.r, use_timestamps=True)
        state = jax.jit(lambda k: jax_init_train_state(jmodel, jprops, self.step_cfg, k, pb))(
            jax.random.PRNGKey(1))
        params = _scale_tables(jax.tree.map(np.asarray, state.params))
        params.update({k: np.asarray(state.params[k]) for k in unscaled})
        self.init = jax.tree.map(np.asarray, state).replace(
            params=params,
            prop_params=tuple(_scale_tables(jax.tree.map(np.asarray, p))
                              for p in state.prop_params))
        self.draws.take()  # the initializers' draws
        self.jstep = jax_build_train_step(jmodel, jprops, self.step_cfg)
        _, _, tmodel, tprops, self.tcfg = build_flagship(tiny=False, overrides=ov, device="cpu")
        if cycle_coef is not None:
            self.tcfg = dataclasses.replace(self.tcfg, cycle_coef=cycle_coef)
        self.tstate = init_train_state(tmodel, tprops)
        self.tstep = build_train_step(tmodel, tprops, self.tcfg)
        self.names = [n for n, _ in tmodel.named_parameters()]
        self.prop_names = [f"{i}.{n}" for i, pm in enumerate(tprops)
                           for n, _ in pm.named_parameters()]

    def batches(self, seed):
        kp, kl = jax.random.split(jax.random.PRNGKey(100 + seed))
        return (jax.tree.map(np.asarray, jax_sample_pixel(self.scene, kp, self.r,
                                                          use_timestamps=True)),
                jax.tree.map(np.asarray, jax_sample_lidar(self.scene, kl, self.r)))

    def jax_run(self, step, seed=7):
        """JAX's iteration at ``step`` from the common state: its metrics,
        the gradients it handed to Adam and the parameters Adam returned
        (update order: pixel proposal, pixel model, lidar proposal, lidar
        model), the batches, the port's draws and JAX's top-K calls."""
        s = self.init
        jstate = jax.tree.map(jnp.array, s).replace(step=jnp.asarray(step, jnp.int32))
        full = jax_lidar_full_at(self.step_cfg, step)
        pb, lb = self.batches(seed)
        _, jm = self.jstep(jstate, pb, lb, jax.random.PRNGKey(seed), pixel_rg=True,
                           lidar_rg=True, lidar_full=full)
        pd, ld = iteration_draws(self.draws.take(), self.step_cfg, full)
        return dict(step=step, full=full, metrics={k: float(v) for k, v in jm.items()},
                    grads=self.grads.take(), updated=self.updated.take(), pb=pb, lb=lb,
                    pd=pd, ld=ld, topk=self.topk.take())

    def run(self, step, monkeypatch, seed=7, jax_record=None):
        """Both packages' iteration at ``step`` from the common state:
        (JAX metrics, port metrics, JAX grads, port grads), grads in
        update order (pixel proposal, pixel model, lidar proposal, lidar
        model)."""
        rec = jax_record or self.jax_run(step, seed)
        self.selections = Selections(rec["topk"])
        self.last = (rec["pb"], rec["lb"], rec["pd"], rec["ld"])
        tm, tgrads = self._port(step, *self.last, self.selections, monkeypatch)
        return rec["metrics"], tm, rec["grads"], tgrads

    def _load_common(self, step):
        s = self.init
        adam, prop_adam = s.opt_state[1], s.prop_opt_state[1]
        load_jax_train_state(self.tstate, s.params, s.prop_params,
                             (adam.count, adam.mu, adam.nu),
                             (prop_adam.count, prop_adam.mu, prop_adam.nu), step)

    def _port(self, step, pb, lb, pd, ld, selections, monkeypatch):
        self._load_common(step)
        tgrads = []
        orig = step_mod.apply_update

        def record(tx, g, opt_state, params, lr):
            tgrads.append([None if x is None else x.detach().clone() for x in g])
            return orig(tx, g, opt_state, params, lr)

        with monkeypatch.context() as m:
            m.setattr(step_mod, "apply_update", record)
            selections.patch(m)
            tm = self.tstep(self.tstate, _to_torch(pb), _to_torch(lb), pd, ld, True, True,
                            lidar_full_at(self.tcfg, step))
        return {k: float(v) for k, v in tm.items()}, tgrads

    def branch(self, rec, lidar, monkeypatch, selections=None, nudge=False):
        """The port's one branch of ``rec``'s iteration alone, from the
        parameters JAX's branch ran on: the common state for the pixel
        branch, the parameters JAX's pixel update returned for the lidar
        branch.  Returns (its metrics, [proposal grads, model grads]);
        ``nudge``: the ray origins one ulp apart."""
        step = rec["step"]
        self._load_common(step)
        if lidar:
            load_jax_params(self.tstate.model, self.tstate.prop_models, rec["updated"][1],
                            rec["updated"][0])
        batch = rec["lb"] if lidar else rec["pb"]
        if nudge:
            batch = dict(batch, origins=np.nextafter(batch["origins"], np.inf).astype(np.float32))
        st = self.tstate
        for p in st.params + st.prop_params:
            p.grad = None
        sel = selections or Selections(rec["topk"])
        with monkeypatch.context() as m:
            sel.patch(m)
            if lidar:
                total, aux = self.tstep.lidar_loss(_to_torch(batch), rec["ld"], step, True,
                                                   rec["full"])
            else:
                total, aux = self.tstep.pixel_loss(_to_torch(batch), rec["pd"], step, True)
            total.backward()
        self.selections = sel
        grads = [[None if p.grad is None else p.grad.detach().clone() for p in ps]
                 for ps in (st.prop_params, st.params)]
        for p in st.params + st.prop_params:
            p.grad = None
        return {k: float(v.detach()) for k, v in aux.items()}, grads

    def floor(self, step, monkeypatch, tgrads):
        """The port's step of the last ``run`` again with the ray origins one
        ulp apart (the same draws, JAX's selections taken wherever they
        differ): each grid-fed model leaf's largest change over its largest
        |grad|, per branch."""
        pb, lb, pd, ld = self.last

        def nudge(b):
            return dict(b, origins=np.nextafter(b["origins"], np.inf).astype(np.float32))

        sel = Selections(self.selections.records, tie=float("inf"))
        _, nudged = self._port(step, nudge(pb), nudge(lb), pd, ld, sel, monkeypatch)
        out = []
        for i in (1, 3):
            rows = []
            for name, a, b in zip(self.names, tgrads[i], nudged[i]):
                if name.startswith(GRID_FED):
                    top = max(float(a.abs().max()), 1e-30)
                    rows.append((float((b - a).abs().max()) / top, name))
            out.append(sorted(rows, reverse=True))
        return out


@contextlib.contextmanager
def topk_tap():
    """Every ``jax.lax.top_k`` traced while open passes out its operand and
    indices."""
    tap = Tap()
    top_k = jax.lax.top_k

    def tapped(x, k):
        v, i = top_k(x, k)
        tap((x, i))
        return v, i

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.lax, "top_k", tapped)
        yield tap


@contextlib.contextmanager
def jax_taps():
    """(draws, gradients, updated parameters, top-K calls): taps on every
    ``jax.random.uniform`` draw, on the gradients the JAX step hands to
    ``apply_update`` and the parameters it gets back, and on every
    ``jax.lax.top_k``, for as long as the context is open."""
    grads, updated = Tap(), Tap()
    apply_update = jax_step_mod.apply_update

    def tapped(tx, g, opt_state, params, lr):
        grads(g)
        new_params, new_opt_state = apply_update(tx, g, opt_state, params, lr)
        updated(new_params)
        return new_params, new_opt_state

    with uniform_tap() as draws, topk_tap() as topk, pytest.MonkeyPatch.context() as m:
        m.setattr(jax_step_mod, "apply_update", tapped)
        yield draws, grads, updated, topk


@pytest.fixture(scope="module")
def taps():
    with jax_taps() as t:
        yield t


@pytest.fixture(scope="module")
def full_width(taps):
    return FullWidth(taps)


@pytest.fixture(scope="module")
def jax_step_2300(full_width):
    """JAX's iteration at step 2,300, shared by the whole-step and the
    lidar-branch tests."""
    return full_width.jax_run(2300)


def apart(jgrads, tgrads, names, prop: bool, prefix=""):
    """Each leaf's (under ``prefix``) largest |port - JAX| over its largest
    |JAX grad|."""
    ref = _named(jgrads, prop)
    out = {}
    for name, t in zip(names, tgrads):
        if name.startswith(prefix):
            r = ref[name].numpy()
            o = np.zeros_like(r) if t is None else t.numpy()
            out[name] = float(np.abs(o - r).max() / max(float(np.abs(r).max()), 1e-30))
    return out


def test_schedules_match_jax(full_width):
    jc, tc = full_width.step_cfg, full_width.tcfg
    assert (tc.num_samples, tc.prop_samples) == (jc.num_samples, jc.prop_samples) == (
        64, (128, 64))
    assert (tc.sample_topk, tc.lidar_sample_topk) == (32, 16)
    for step in (0, 1999, 2000, 2001) + STEPS + (2249, 2250, 2499, 7000, 7001, 12001):
        assert los_decay_weight(tc, step) == float(jax_los_decay_weight(jc, step)), step
        assert lidar_full_at(tc, step) == jax_lidar_full_at(jc, step), step
    assert [lidar_full_at(tc, s) for s in STEPS] == [False, True]


# tier-1 takes the unpruned step (each lidar schedule is a JAX compile of
# about a minute on the sandbox CPU); the script runs both STEPS
@pytest.mark.parametrize("step", [2300])
def test_full_width_step_matches_jax(full_width, jax_step_2300, step, monkeypatch):
    jm, tm, jgrads, tgrads = full_width.run(step, monkeypatch, jax_record=jax_step_2300)
    sel = full_width.selections
    print(f"step {step}: JAX {jm}\nport {tm}\nselections {sel.paired}, ties {sel.ties}")
    assert sel.paired == 3  # the port's three selections, each paired with a JAX call
    _assert_losses_close(tm, jm)
    assert jm["lidar_line_of_sight"] > 0 and jm["prop_loss"] > 0 and jm["range_rmse"] > 0
    order = ["prop", "model", "prop", "model"]
    assert len(jgrads) == len(tgrads) == len(order)
    for i, (kind, jg, tg) in enumerate(zip(order, jgrads, tgrads)):
        # the lidar branch runs on the params the pixel branch's Adam step
        # moved (lr 0.01 at count 0: test_torch_train_step.py's LoS case)
        names = full_width.prop_names if kind == "prop" else full_width.names
        atol = GRAD_ATOL if i < 2 else LIDAR_GRAD_ATOL_AFTER_LR_1E2
        ref = _named(jg, kind == "prop")
        for name, t in zip(names, tg):
            fed = kind == "model" and name.startswith(GRID_FED)
            _assert_grads_close({name: ref[name]}, [t], [name],
                                atol=GRID_FED_ATOL if fed else atol)


def assert_branch_matches_jax(fw, rec, lidar, monkeypatch):
    """The port's ``lidar`` (or pixel) branch alone from the parameters
    JAX's ran on: each of its losses at ``test_torch_train_step.py``'s
    tolerances, every flow_mlp leaf at ``LIDAR_FLOW_MLP_ATOL`` (or
    ``FLOW_MLP_ATOL``), the other grid-fed leaves at ``GRID_FED_ATOL`` and
    the rest at ``GRAD_ATOL``; returns each flow_mlp leaf's distance from
    JAX."""
    tm, (tp, tg) = fw.branch(rec, lidar, monkeypatch)
    jm = rec["metrics"]
    assert fw.selections.paired == (1 if lidar else 2), fw.selections.paired
    assert set(tm) <= set(jm)
    _assert_losses_close(tm, {k: jm[k] for k in tm})
    jp, jg = rec["grads"][2:] if lidar else rec["grads"][:2]
    _assert_grads_close(_named(jp, True), tp, fw.prop_names)
    ref = _named(jg, False)
    flow_atol = LIDAR_FLOW_MLP_ATOL if lidar else FLOW_MLP_ATOL
    for name, t in zip(fw.names, tg):
        atol = (flow_atol if name.startswith("flow_mlp.") else
                GRID_FED_ATOL if name.startswith(GRID_FED) else GRAD_ATOL)
        _assert_grads_close({name: ref[name]}, [t], [name], atol=atol)
    return apart(jg, tg, fw.names, False, "flow_mlp.")


def test_lidar_branch_from_jax_updated_params_matches_jax(full_width, jax_step_2300,
                                                          monkeypatch):
    """The lidar branch of step 2,300 alone in the port, from the parameters
    JAX's pixel update returned: no count-0 Adam sign step between the two
    (module docstring)."""
    flow = assert_branch_matches_jax(full_width, jax_step_2300, True, monkeypatch)
    print(f"lidar branch flow_mlp, largest |port - JAX| / max |JAX|: {flow}")
    assert jax_step_2300["metrics"]["lidar_line_of_sight"] > 0


def _worst(jm, tm, jgrads, tgrads, names, prop_names, lidar_atol):
    """Each loss's relative difference, and for every branch each leaf
    with elements outside the gradient tolerance: (share outside, largest
    |difference| over the leaf's largest |grad|, leaf)."""
    losses = {k: abs(tm[k] - v) / max(abs(v), 1e-30) for k, v in jm.items()}
    worst = []
    for i, (kind, jg, tg) in enumerate(zip(["prop", "model", "prop", "model"], jgrads, tgrads)):
        ref = _named(jg, kind == "prop")
        atol = GRAD_ATOL if i < 2 else lidar_atol
        rows = []
        for name, t in zip(prop_names if kind == "prop" else names, tg):
            r = ref[name].numpy()
            o = np.zeros_like(r) if t is None else t.numpy()
            top = max(float(np.abs(r).max()), 1e-30)
            out = np.abs(o - r) > GRAD_RTOL * np.abs(r) + atol * top
            if out.any():
                rows.append((float(out.mean()), float(np.abs(o - r).max() / top), name))
        worst.append(sorted(rows, reverse=True))
    return losses, worst


def main(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rays", type=int, default=8192)
    p.add_argument("--smooth-dynamic", action="store_true",
                   help="leave the fused dynamic-and-flow table at JAX's initializer's "
                        "U(+-1e-4), so that a brick face moves its encoding 2000x less")
    p.add_argument("--floor", action="store_true",
                   help="also run the port with the ray origins one ulp apart and print "
                        "each grid-fed leaf's spread")
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(8)

    with jax_taps() as taps, pytest.MonkeyPatch.context() as m:
        fw = FullWidth(taps, rays=args.rays,
                       unscaled=("dynflow_table",) if args.smooth_dynamic else ())
        for step in STEPS:
            jm, tm, jg, tg = fw.run(step, m)
            losses, worst = _worst(jm, tm, jg, tg, fw.names, fw.prop_names,
                                   LIDAR_GRAD_ATOL_AFTER_LR_1E2)
            print(f"step {step} rays {args.rays}+{args.rays}; selections taken from JAX at "
                  f"ties (site, ray, K-th gap, operand difference): {fw.selections.ties}")
            for k in sorted(jm):
                print(f"  {k:22s} JAX {jm[k]:.8g} port {tm[k]:.8g} rel {losses[k]:.3g} "
                      f"(tolerance {LOSS_RTOL.get(k, 1e-4):g})")
            for branch, rows in zip(["pixel prop", "pixel model", "lidar prop",
                                     "lidar model"], worst):
                print(f"  {branch} gradients with elements outside the tolerance "
                      f"(share, largest difference / max |grad|, leaf): {rows}")
            if args.floor:
                for branch, rows in zip(["pixel model", "lidar model"], fw.floor(step, m, tg)):
                    print(f"  {branch}: the port against itself, ray origins one ulp apart "
                          f"(largest difference / max |grad|, leaf): {rows}")


if __name__ == "__main__":
    main(sys.argv[1:])
