"""Purser (1987) spatial filters for radiation quantities (counterpart of
`castro_tpu/radiation/filter.py`; reference `Source/radiation/filter.H`
ff1..ff4 and the `filter_lambda_T` / `filter_prim_T` plumbing in
`Radiation.cpp:53-136`): symmetric (2T+1)-point low-pass stencils that
remove grid-scale odd-even noise from the flux limiter (and optionally the
primitives) while preserving polynomials up to degree 2S+1, S = 0.

Stencils run along each spatial axis with edge-clamped ghosts."""

from __future__ import annotations

import numpy as np
import torch

# half-stencils [w0, w1, ..., wT] (Purser 1987 Table 1 / filter.H, S=0)
_HALF = {
    1: np.array([0.50, 0.25]),
    2: np.array([0.625, 0.25, -0.0625]),
    3: np.array([44.0, 15.0, -6.0, 1.0]) / 64.0,
    4: np.array([186.0, 56.0, -28.0, 8.0, -1.0]) / 256.0,
}


def filter_kernel(T: int) -> np.ndarray:
    """Full symmetric (2T+1)-point kernel for filter order T in 1..4."""
    h = _HALF[int(T)]
    return np.concatenate([h[:0:-1], h])


def apply_filter(field, T: int, axes=None):
    """Filter `field` along the given axes (default: all). T=0 is a no-op.
    Edge handling: clamp (replicate the boundary cells)."""
    if T <= 0:
        return field
    k = torch.tensor(filter_kernel(T), dtype=field.dtype, device=field.device)
    t = int(T)
    axes = range(field.dim()) if axes is None else axes
    out = field
    for ax in axes:
        n = out.shape[ax]
        idx = torch.arange(-t, n + t, device=field.device).clamp_(0, n - 1)
        g = out.index_select(ax, idx)
        acc = torch.zeros_like(out)
        for j in range(2 * t + 1):
            acc = acc + k[j] * g.narrow(ax, j, n)
        out = acc
    return out
