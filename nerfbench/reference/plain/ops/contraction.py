"""Scene contraction (port of ``emernerf_tpu/ops/contraction.py``).

MERF-style piecewise-projective contraction with the infinity norm:
normalize into the aabb ([-1, 1]^3), identity inside the unit cube,
``(2 - 1/|x|) * x/|x|`` outside, then map [-2, 2] -> [0, 1].
"""

import torch


def normalize_aabb(x: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """Map world points into [0, 1] relative to an aabb [min3, max3]."""
    aabb_min, aabb_max = aabb[..., :3], aabb[..., 3:]
    return (x - aabb_min) / (aabb_max - aabb_min)


def contract_merf(x: torch.Tensor, aabb: torch.Tensor,
                  eps: float = 1e-12) -> torch.Tensor:
    """Contract unbounded points to [0, 1] (inf-norm piecewise projective)."""
    x = normalize_aabb(x, aabb) * 2.0 - 1.0
    mag = x.abs().amax(dim=-1, keepdim=True)
    safe_mag = mag.clamp_min(eps)
    x = torch.where(mag < 1.0, x, (2.0 - 1.0 / safe_mag) * (x / safe_mag))
    return x / 4.0 + 0.5


def inside_unit_cube_selector(normed: torch.Tensor, dtype=None) -> torch.Tensor:
    """1.0 where all coords lie strictly inside (0, 1); else 0.0."""
    sel = ((normed > 0.0) & (normed < 1.0)).all(dim=-1)
    return sel.to(dtype or normed.dtype)
