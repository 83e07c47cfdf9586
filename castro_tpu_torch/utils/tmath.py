"""Elementwise max, min and clip against a constant with the JAX
package's derivative at a tie (half the tangent to each side, as
torch.maximum/torch.minimum give it, where torch.clamp gives all of it):
the burner differentiates the EOS and the network through them
(`integrators/stiff.py`), and a species at exactly 0 sits on such a tie.
The constants are 0-d tensors kept per value, dtype and device."""

from __future__ import annotations

import torch

_CONST = {}


def _c(value, like):
    key = (float(value), like.dtype, like.device)
    t = _CONST.get(key)
    if t is None:
        t = torch.tensor(float(value), dtype=like.dtype, device=like.device)
        _CONST[key] = t
    return t


def vmax(x, value):
    """jnp.maximum(x, value)."""
    return torch.maximum(x, _c(value, x))


def vmin(x, value):
    """jnp.minimum(x, value)."""
    return torch.minimum(x, _c(value, x))


def clip(x, lo, hi):
    """jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi)."""
    return vmin(vmax(x, lo), hi)
