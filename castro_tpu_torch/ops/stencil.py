"""Shifted-view stencil helpers (counterpart of `castro_tpu/ops/stencil.py`).

Every intermediate field keeps the full grown shape `[..., nx+2g, ny+2g,
nz+2g]`; a stencil access `a[i+off]` is a same-shape `shifted` copy with
the edge value repeated (edge clamp). Values within `|off|` cells of the
array edge are garbage by construction, like the unfilled ghost margin of
the reference's grown FABs; the CTU chain's total reach is <= NUM_GROW=4, so
the interior is always valid. The CUDA kernels reproduce the same clamp by
clamping each neighbour index to the array.
"""

from __future__ import annotations

import torch


def shifted(a: torch.Tensor, off: int, axis: int) -> torch.Tensor:
    """Return b with b[..., i, ...] = a[..., clamp(i+off), ...]."""
    if off == 0:
        return a
    n = a.shape[axis]
    if n == 1:
        # broadcast (metric) axis: constant along this axis
        return a
    k = abs(off)
    if k >= n:
        raise ValueError(f"shift {off} exceeds axis size {n}")
    if off > 0:
        core = a.narrow(axis, k, n - k)
        edge = a.narrow(axis, n - 1, 1)
        return torch.cat([core] + [edge] * k, dim=axis)
    core = a.narrow(axis, 0, n - k)
    edge = a.narrow(axis, 0, 1)
    return torch.cat([edge] * k + [core], dim=axis)


def interior_slice(ng: int, dim: int, comp_ndim: int = 1):
    """Slicer selecting the valid interior of a grown array."""
    return (slice(None),) * comp_ndim + (slice(ng, -ng),) * dim
