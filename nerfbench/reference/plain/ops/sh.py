"""Spherical-harmonics direction encoding, degrees 1-4 (port of
``emernerf_tpu/ops/sh.py``).

Real spherical harmonics with the hardcoded coefficients of Instant-NGP and
tiny-cuda-nn (Sloan, "Stupid Spherical Harmonics Tricks"): elementwise
math on tensors, no kernel.  As in tiny-cuda-nn, inputs are expected in
[0, 1]^3 and are mapped to [-1, 1] first.
"""

from __future__ import annotations

import torch


def sh_output_dim(degree: int) -> int:
    return degree * degree


def sh_encode(directions: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """directions (..., 3) in [0, 1] -> (..., degree^2)."""
    if not 1 <= degree <= 4:
        raise ValueError(f"SH encoding supports degrees 1..4, got {degree}")
    d = directions * 2.0 - 1.0
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z

    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree >= 3:
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (x2 - y2),
        ]
    if degree >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    return torch.stack(out, dim=-1)
