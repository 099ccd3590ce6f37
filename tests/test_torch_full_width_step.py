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
branch's flow MLP at step 2,100; 1.7% at 2,300; 4.7% at 2,048 rays).  With
the fused table left at its initializer's U(+-1e-4) (``--smooth-dynamic``)
the pixel branch's flow-MLP gradients agree with JAX's to 1e-5 and the
lidar branch's stay 2-5% apart, as the port's own one-ulp spread there
does (0.6-1.7%): that branch's flow gradient is not smooth in the sample
positions for another reason than the brick faces.  Every other leaf (the
heads, the proposal nets) is held at ``test_torch_train_step.py``'s
tolerances.

The test takes 256 + 256 rays at step 2,300 (the JAX step compiles for
about a minute for each lidar schedule); as a script
(``python tests/test_torch_full_width_step.py --rays 8192 [--floor]``) it
takes one full batch of 8,192 + 8,192 rays at both steps and prints every
loss and each branch's gradient leaves outside the tolerance.
"""

import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import (  # noqa: F401  (taps is a fixture)
    GRAD_ATOL,
    GRAD_RTOL,
    LIDAR_GRAD_ATOL_AFTER_LR_1E2,
    LOSS_RTOL,
    _assert_grads_close,
    _assert_losses_close,
    _named,
    _scale_tables,
    _to_torch,
    taps,
)

import emernerf_torch.models.fields as fields_mod
import emernerf_torch.render.renderer as renderer_mod
import emernerf_torch.train.step as step_mod
from emernerf_torch.convert import load_jax_train_state
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
        return torch.from_numpy(jidx.astype(np.int64))

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
    jitted step built inside the draw and gradient taps."""

    def __init__(self, taps, topk, rays: int = RAYS, unscaled=()):
        """``unscaled``: model tables left at JAX's initializer's scale."""
        self.draws, self.grads = taps
        self.topk = topk
        ov = overrides(rays)
        cfg, dataset, jmodel, jprops, self.step_cfg = jax_build_flagship(tiny=False, overrides=ov)
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

    def run(self, step, monkeypatch, seed=7):
        """Both packages' iteration at ``step`` from the common state:
        (JAX metrics, port metrics, JAX grads, port grads), grads in
        update order (pixel proposal, pixel model, lidar proposal, lidar
        model)."""
        s = self.init
        jstate = jax.tree.map(jnp.array, s).replace(step=jnp.asarray(step, jnp.int32))
        adam, prop_adam = s.opt_state[1], s.prop_opt_state[1]
        full = jax_lidar_full_at(self.step_cfg, step)
        pb, lb = self.batches(seed)
        _, jm = self.jstep(jstate, pb, lb, jax.random.PRNGKey(seed), pixel_rg=True,
                           lidar_rg=True, lidar_full=full)
        jm = {k: float(v) for k, v in jm.items()}
        draws, jgrads = self.draws.take(), self.grads.take()
        pd, ld = iteration_draws(draws, self.step_cfg, full)
        self.selections = Selections(self.topk.take())
        self.last = (pb, lb, pd, ld)
        tm, tgrads = self._port(step, pb, lb, pd, ld, self.selections, monkeypatch)
        return jm, tm, jgrads, tgrads

    def _port(self, step, pb, lb, pd, ld, selections, monkeypatch):
        s = self.init
        adam, prop_adam = s.opt_state[1], s.prop_opt_state[1]
        load_jax_train_state(self.tstate, s.params, s.prop_params,
                             (adam.count, adam.mu, adam.nu),
                             (prop_adam.count, prop_adam.mu, prop_adam.nu), step)
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


@pytest.fixture(scope="module")
def full_width(taps):  # noqa: F811
    with topk_tap() as topk:
        yield FullWidth(taps, topk)


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
def test_full_width_step_matches_jax(full_width, step, monkeypatch):
    jm, tm, jgrads, tgrads = full_width.run(step, monkeypatch)
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
    import emernerf_tpu.train.step as jax_step_mod

    grads = Tap()
    apply_update = jax_step_mod.apply_update

    def tapped(tx, g, opt_state, params, lr):
        grads(g)
        return apply_update(tx, g, opt_state, params, lr)

    with uniform_tap() as draws, topk_tap() as topk, pytest.MonkeyPatch.context() as m:
        m.setattr(jax_step_mod, "apply_update", tapped)
        fw = FullWidth((draws, grads), topk, rays=args.rays,
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
