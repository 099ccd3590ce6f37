"""ReLU MLPs with skip connections (port of ``emernerf_tpu/models/mlp.py``).

Every module takes a compute ``dtype``: params stay fp32, inputs and
weights are cast to ``dtype`` for the matmuls, and the final output is cast
back to fp32.  The matmuls are ``nn.Linear`` products (cuBLAS on the card).
"""

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nerfbench.reference.plain.models.init_utils import torch_linear_init_
from nerfbench.reference.plain.ops import lowp


class TorchDense(nn.Linear):
    """nn.Linear with a compute dtype and a seeded torch-default init."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.float32, device=None, generator=None):
        super().__init__(in_features, out_features, device=device)
        self.compute_dtype = dtype
        torch_linear_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(lowp.rnd(x.to(cd)), lowp.rnd(self.weight.to(cd)),
                        lowp.rnd(self.bias.to(cd)))


class MLP(nn.Module):
    """``num_layers`` linears; at each hidden layer index in
    ``skip_connections`` (other than 0) the input is concatenated first;
    ReLU after every layer but the last."""

    def __init__(self, in_dims: int, out_dims: int, num_layers: int = 3,
                 hidden_dims: int = 256, skip_connections: Tuple[int, ...] = (0,),
                 dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.skips = tuple(i for i in skip_connections if i > 0)
        kw = dict(dtype=dtype, device=device, generator=generator)
        layers, d = [], in_dims
        for i in range(num_layers - 1):
            if i in self.skips:
                d += in_dims
            layers.append(TorchDense(d, hidden_dims, **kw))
            d = hidden_dims
        layers.append(TorchDense(d, out_dims, **kw))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        inp = x
        for i, layer in enumerate(self.layers[:-1]):
            if i in self.skips:
                x = torch.cat([x, inp], dim=-1)
            x = torch.relu(layer(x))
        return self.layers[-1](x).float()


class Sequential64(nn.Module):
    """Linear-ReLU-...-Linear stack: ``widths`` are the hidden widths then
    the output width."""

    def __init__(self, in_dims: int, widths: Sequence[int],
                 final_sigmoid: bool = False, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.final_sigmoid = final_sigmoid
        dims = [in_dims, *widths]
        self.layers = nn.ModuleList(
            TorchDense(a, b, dtype=dtype, device=device, generator=generator)
            for a, b in zip(dims[:-1], dims[1:])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        x = self.layers[-1](x).float()
        return torch.sigmoid(x) if self.final_sigmoid else x
