"""Reaction networks: the inert `general_null` composition carrier.

Counterpart of `castro_tpu/network/general_null.py` and `make_network`.
Reactive networks are not ported yet (ROADMAP.md, queue 1 item 7)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

# species properties for the common general_null .net files
_KNOWN = {
    "X": (1.0, 1.0),
    "H1": (1.0, 1.0),
    "He4": (4.0, 2.0),
    "C12": (12.0, 6.0),
    "N14": (14.0, 7.0),
    "O16": (16.0, 8.0),
    "Ne20": (20.0, 10.0),
    "Mg24": (24.0, 12.0),
    "Si28": (28.0, 14.0),
    "Fe56": (56.0, 26.0),
    "ash": (1.0, 1.0),
    "fuel": (1.0, 1.0),
    "inert": (1.0, 1.0),
}


class GeneralNullNetwork:
    """Species metadata of an inert network (reference Microphysics
    networks/general_null): names, mass numbers `aion`, charges `zion`."""

    reactive = False

    def __init__(self, spec_names=("X",), aux_names=()):
        self.spec_names: Tuple[str, ...] = tuple(spec_names)
        self.aux_names: Tuple[str, ...] = tuple(aux_names)
        self.aion = np.array([_KNOWN.get(s, (1.0, 1.0))[0] for s in spec_names])
        self.zion = np.array([_KNOWN.get(s, (1.0, 1.0))[1] for s in spec_names])

    @property
    def nspec(self) -> int:
        return len(self.spec_names)

    @property
    def naux(self) -> int:
        return len(self.aux_names)


def make_network(params) -> GeneralNullNetwork:
    name = params.network.network_name
    if name in ("general_null", "null"):
        return GeneralNullNetwork(spec_names=params.network.spec_names or ("X",),
                                  aux_names=params.network.aux_names)
    raise NotImplementedError(
        f"network {name!r} is not ported (ROADMAP.md, queue 1 item 7)")
