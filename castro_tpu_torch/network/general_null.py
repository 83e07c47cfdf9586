"""general_null: the inert composition carrier (counterpart of
`castro_tpu/network/general_null.py`; reference Microphysics
networks/general_null)."""

from __future__ import annotations

import numpy as np

from castro_tpu_torch.network.base import Network

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


class GeneralNullNetwork(Network):
    reactive = False

    def __init__(self, spec_names=("X",), aux_names=()):
        a = np.array([_KNOWN.get(s, (1.0, 1.0))[0] for s in spec_names])
        z = np.array([_KNOWN.get(s, (1.0, 1.0))[1] for s in spec_names])
        super().__init__(spec_names, aion=a, zion=z, aux_names=aux_names)
