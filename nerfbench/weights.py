"""The initial weights of a run, made by the benchmark from the seed on the
device, and handed alike to the program and to the reference.

One uniform draw in [-1, 1) of every parameter at once (one call of a
``torch.Generator`` on the device), cut into the leaves in order and scaled
per leaf by a rule on its name and shape:

- a grid table (``...table``): the configuration's ``init.table_scale``;
- an embedding or the learnable PE map: unit variance (sqrt 3);
- a linear layer's weight (out, in) and its bias: 1/sqrt(in), as
  ``torch.nn.Linear`` draws them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

# seeds of the weights and of the draws: two streams of one seed
DRAW_STREAM = 1 << 40


def named_leaves(model, prop_models) -> List[Tuple[str, torch.nn.Parameter]]:
    """The parameters in the train state's order: the model's, then each
    proposal net's (``prop<i>.`` before its names)."""
    out = list(model.named_parameters())
    for i, pm in enumerate(prop_models):
        out += [(f"prop{i}.{n}", p) for n, p in pm.named_parameters()]
    return out


def leaf_scales(names_shapes: Sequence[Tuple[str, Tuple[int, ...]]],
                init: Dict[str, float]) -> List[float]:
    fan_in = {n[:-len("weight")]: s[1] for n, s in names_shapes
              if n.endswith("weight") and len(s) == 2}
    scales = []
    for n, s in names_shapes:
        if n.endswith("table"):
            scales.append(float(init["table_scale"]))
        elif "embedding" in n or "pe_map" in n:
            scales.append(math.sqrt(3.0))
        elif n.endswith("weight") and len(s) == 2:
            scales.append(1.0 / math.sqrt(s[1]))
        elif n.endswith("bias") and n[:-len("bias")] in fan_in:
            scales.append(1.0 / math.sqrt(fan_in[n[:-len("bias")]]))
        else:
            raise ValueError(f"no initialisation rule for the parameter {n} {tuple(s)}")
    return scales


def make_weights(names_shapes: Sequence[Tuple[str, Tuple[int, ...]]], init: Dict[str, float],
                 seed: int, device) -> List[torch.Tensor]:
    """fp32 leaves from ``seed``, in the order of ``names_shapes``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sizes = [math.prod(s) for _, s in names_shapes]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    out, off = [], 0
    for (_, shape), n, scale in zip(names_shapes, sizes, leaf_scales(names_shapes, init)):
        out.append(flat[off:off + n].view(shape).mul_(scale))
        off += n
    return out


@torch.no_grad()
def load_weights(leaves: Sequence[Tuple[str, torch.nn.Parameter]], init: Dict[str, float],
                 seed: int) -> None:
    """Fill ``leaves`` (named_leaves) with the seed's weights."""
    dev = leaves[0][1].device
    ws = make_weights([(n, tuple(p.shape)) for n, p in leaves], init, seed, dev)
    for (_, p), w in zip(leaves, ws):
        p.copy_(w)
