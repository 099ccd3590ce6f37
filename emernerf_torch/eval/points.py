"""Chunked point queries against the radiance field (port of
``emernerf_tpu/eval/points.py``), for the lidar scene-flow evaluation and the
voxel visualisation.

Chunks of ``chunk_size`` points go to the device under ``torch.no_grad()``
and come back as numpy.  The JAX package pads the last chunk to a fixed
shape for ``jit``; here the last chunk is simply shorter, and each point's
result does not depend on the chunking, except under the eval-time
temporal interpolation, which (as in the reference) anchors a chunk at the
training timesteps nearest its first point's time: every caller queries
one timestep per call.  Queries are eval queries (``train=False``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from emernerf_torch import resolve_device


class PointQueryEngine:
    """``query_flow`` / ``query_attributes`` of a ``RadianceField`` over
    numpy points, on one device: the card unless the caller asks for another
    (raises where there is no card)."""

    def __init__(self, model, chunk_size: int = 65536, device="cuda"):
        self.model = model
        self.chunk_size = chunk_size
        self.device = resolve_device(device)

    @torch.no_grad()
    def _run(self, fn, positions: np.ndarray,
             timestamps: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
        def dev(a, lo, hi):
            return torch.from_numpy(np.ascontiguousarray(a[lo:hi], np.float32)).to(self.device)

        outs = []
        for lo in range(0, len(positions), self.chunk_size):
            hi = lo + self.chunk_size
            t = None if timestamps is None else dev(timestamps, lo, hi)
            out = fn(dev(positions, lo, hi), t, train=False)
            outs.append({k: v.cpu().numpy() for k, v in out.items()})
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def query_flow(self, positions: np.ndarray, timestamps: np.ndarray) -> Dict[str, np.ndarray]:
        """forward_flow, backward_flow (N, 3) and dynamic_density (N,) of
        positions (N, 3) at normalized timestamps (N,)."""
        return self._run(self.model.query_flow, positions, timestamps)

    def query_attributes(self, positions: np.ndarray,
                         timestamps: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """The densities (and flows) of positions (N, 3); static only without
        timestamps."""
        return self._run(self.model.query_attributes, positions, timestamps)
