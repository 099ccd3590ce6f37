"""NeRF sinusoidal positional encoding (port of ``emernerf_tpu/ops/sinusoidal.py``).

Output layout ``[x, sin(x*2^m..), cos(x*2^m..)]`` with frequencies fastest
over input dims; cos is computed as ``sin(xb + pi/2)``.
"""

import math

import torch


def sinusoidal_output_dim(n_input_dims, min_deg=0, max_deg=4, enable_identity=True):
    return (int(enable_identity) + (max_deg - min_deg + 1) * 2) * n_input_dims


def sinusoidal_encode(x: torch.Tensor, min_deg=0, max_deg=4,
                      enable_identity=True) -> torch.Tensor:
    """x: (..., D) -> (..., sinusoidal_output_dim)."""
    if max_deg == min_deg:
        return x
    scales = torch.tensor([2.0**i for i in range(min_deg, max_deg + 1)],
                          dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    encoded = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    if enable_identity:
        encoded = torch.cat([x, encoded], dim=-1)
    return encoded
