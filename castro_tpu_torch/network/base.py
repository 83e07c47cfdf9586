"""Network base class (counterpart of `castro_tpu/network/base.py`)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class Network:
    """Species metadata and, for reactive networks, the burn RHS.

    Attributes
    ----------
    spec_names : tuple of species names
    aion, zion : numpy arrays [nspec], mass and charge numbers
    ebin       : numpy array [nspec], binding energy per gram (erg/g)
    reactive   : whether the RHS does anything
    """

    spec_names: Tuple[str, ...] = ()
    aux_names: Tuple[str, ...] = ()
    reactive: bool = False

    def __init__(self, spec_names=(), aion=None, zion=None, ebin=None, aux_names=()):
        self.spec_names = tuple(spec_names)
        n = len(self.spec_names)
        self.aux_names = tuple(aux_names)
        self.aion = np.asarray(aion if aion is not None else np.ones(n), dtype=np.float64)
        self.zion = np.asarray(zion if zion is not None else np.ones(n), dtype=np.float64)
        self.ebin = np.asarray(ebin if ebin is not None else np.zeros(n), dtype=np.float64)

    @property
    def nspec(self) -> int:
        return len(self.spec_names)

    @property
    def naux(self) -> int:
        return len(self.aux_names)

    def column(self, values, like, ndim):
        """A per-species constant as a tensor of like's dtype and device,
        shaped [nspec, 1, ...] to broadcast against an [nspec, *grid] of
        `ndim` grid axes. Kept on the network, keyed by the values
        themselves: a host-to-device copy is not allowed while a CUDA
        graph captures the burner's iteration."""
        a = np.asarray(values, dtype=np.float64)
        key = (a.tobytes(), like.dtype, like.device, ndim)
        cache = self.__dict__.setdefault("_columns", {})
        col = cache.get(key)
        if col is None:
            col = torch.as_tensor(a, dtype=like.dtype, device=like.device).reshape(
                (-1,) + (1,) * ndim)
            cache[key] = col
        return col

    def rhs(self, rho, T, xn, e=None):
        """Vectorized RHS: (xdot[nspec, ...], edot[...]); zero for an inert
        network (general_null)."""
        return torch.zeros_like(xn), torch.zeros_like(rho)
