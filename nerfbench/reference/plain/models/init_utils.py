"""Initializers (port of ``emernerf_tpu/models/init_utils.py``).

torch.nn.Linear: weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in));
torch.nn.Embedding: weight ~ N(0, 1).  Both draw from an explicit
``torch.Generator`` so a model is reproducible from its seed.
"""

import math

import torch
from torch import nn


@torch.no_grad()
def torch_linear_init_(layer: nn.Linear, generator=None) -> None:
    bound = 1.0 / math.sqrt(layer.in_features)
    nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
    nn.init.uniform_(layer.bias, -bound, bound, generator=generator)


@torch.no_grad()
def torch_embedding_init_(emb: nn.Embedding, generator=None) -> None:
    nn.init.normal_(emb.weight, 0.0, 1.0, generator=generator)
