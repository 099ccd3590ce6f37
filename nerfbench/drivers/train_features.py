"""The training window of ``drivers/train.py`` for a configuration with
EmerNeRF's feature head, with one more number compared: ``dino_feat``.

``dino_feat`` reads the composited DINO feature of the first compared
iteration's pixel rays (the first render whose composite carries one; the
weights are still the seed's on both sides), the program's against the
reference's, in its two parts where the learnable PE map is on: the
field's and the sky's (``dino_pe_free``) and the PE map's (``dino_pe``).
Each part's gap is the norm of the difference over the reference's norm;
``dino_feat`` is the larger.  A gradient sums over every sample of the
batch, so an unbiased rounding of the head's output (the head in fp8)
averages out of ``grad`` and ``grad_diff``; the feature each ray renders
keeps it.  The parts are read apart because the PE map's term is most of
the feature's norm and would hide the field's.

A cell takes this driver with ``"kind": "train_features"`` in its own file,
over its traffic mix's kind: the traffic's parameters are unchanged.
Workload keys: those of ``drivers/train.py``; ``limits`` adds ``dino_feat``.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Any, Dict, List, Optional

import torch

from nerfbench import harness
from nerfbench.reference import compare

train = harness.load_module("drivers", "train.py")
# the parts compared where the PE map is on, else the feature itself
PARTS = ("dino_pe_free", "dino_pe")


def _program_renderer():
    from emernerf_torch.render import renderer

    return renderer


def _reference_renderer():
    from nerfbench.reference.plain.render import renderer

    return renderer


@contextlib.contextmanager
def first_features(module, got: Dict[str, Any], key: str):
    """Inside ``with``: ``got[key]`` holds the composited ``dino_feat`` and its
    parts (float32, on the CPU) of the first call of ``module.composite_rays``
    that returns one; the call after it is the module's own again."""
    orig = module.composite_rays

    def composite_rays(*args, **kw):
        out = orig(*args, **kw)
        if "dino_feat" in out:
            got[key] = {k: out[k].detach().float().cpu() for k in ("dino_feat",) + PARTS
                        if k in out}
            module.composite_rays = orig
        return out

    module.composite_rays = composite_rays
    try:
        yield got
    finally:
        module.composite_rays = orig


@torch.no_grad()
def feature_gap(prog: Optional[Dict[str, torch.Tensor]],
                ref: Optional[Dict[str, torch.Tensor]]) -> float:
    """The largest part's |prog - ref| / |ref| over every ray and channel;
    inf where a side rendered no feature or the two differ in parts or
    shapes."""
    if prog is None or ref is None or prog.keys() != ref.keys():
        return float("inf")
    parts = PARTS if all(k in ref for k in PARTS) else ("dino_feat",)
    gap = 0.0
    for k in parts:
        if prog[k].shape != ref[k].shape:
            return float("inf")
        num = torch.linalg.vector_norm((prog[k] - ref[k]).double())
        gap = max(gap, float(num / torch.linalg.vector_norm(ref[k].double())))
    return gap


def compared_setup(ctx: harness.Ctx) -> Dict[str, Any]:
    """``drivers/train.py``'s, with the program's ``dino_feat`` in ``prog``."""
    got: Dict[str, Any] = {}
    with first_features(_program_renderer(), got, "f"):
        s = train.compared_setup(ctx)
    s["prog"]["dino_feat"] = got.get("f")
    return s


def follow_train(*args, **kw) -> Dict[str, Any]:
    """``compare.follow_train``, with the reference's ``dino_feat``."""
    got: Dict[str, Any] = {}
    with first_features(_reference_renderer(), got, "f"):
        ref = compare.follow_train(*args, **kw)
    ref["dino_feat"] = got.get("f")
    return ref


def numbers(prog, ref, diff_quantile: float) -> Dict[str, float]:
    return dict(compare.train_numbers(prog, ref, diff_quantile),
                dino_feat=feature_gap(prog["dino_feat"], ref["dino_feat"]))


def checks(nums: Dict[str, float], limits) -> List[harness.Check]:
    return compare.train_checks(nums, limits) + [
        harness.Check("dino_feat", nums["dino_feat"], float(limits["dino_feat"]))]


def run(ctx: harness.Ctx) -> harness.Outcome:
    got: Dict[str, Any] = {}
    with first_features(_program_renderer(), got, "program"), \
            first_features(_reference_renderer(), got, "reference"):
        out = train.run(ctx)
    gap = feature_gap(got.get("program"), got.get("reference"))
    print(f"nerfbench: dino_feat of the first compared pixel batch: {gap!r}", file=sys.stderr)
    out.checks.append(harness.Check("dino_feat", gap,
                                    float(ctx.workload["limits"]["dino_feat"])))
    return out
