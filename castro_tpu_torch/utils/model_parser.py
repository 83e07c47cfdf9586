"""1D initial-model file reader (counterpart of
`castro_tpu/utils/model_parser.py`, a numpy copy; reference
`Util/model_parser_cxx`): reads the AMReX-astro initial-model format used
by flame_wave, massive_star, wdmerger etc., and interpolates onto a
simulation grid.

Format:
    # npts = N
    # num of variables = M
    # density
    # temperature
    ... (M variable-name comment lines)
    r_1  v_1,1 ... v_1,M
    ...
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class InitialModel:
    def __init__(self, r: np.ndarray, data: Dict[str, np.ndarray]):
        self.r = r
        self.data = data

    @classmethod
    def from_file(cls, path: str) -> "InitialModel":
        names = []
        npts = None
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("#"):
                    body = line.lstrip("#").strip()
                    if body.lower().startswith("npts"):
                        npts = int(body.split("=")[1])
                    elif "num of variables" in body.lower():
                        pass
                    elif "=" not in body and body:
                        names.append(body.split()[0])
                else:
                    rows.append([float(t) for t in line.split()])
        arr = np.asarray(rows)
        if npts is not None and arr.shape[0] != npts:
            raise ValueError(f"{path}: expected {npts} rows, got {arr.shape[0]}")
        r = arr[:, 0]
        data = {}
        for i, name in enumerate(names[: arr.shape[1] - 1]):
            data[name] = arr[:, 1 + i]
        return cls(r, data)

    def interpolate(self, name: str, r_query: np.ndarray) -> np.ndarray:
        """Linear interpolation with edge clamping (reference
        interpolate() semantics)."""
        return np.interp(r_query, self.r, self.data[name])

    @property
    def names(self):
        return list(self.data)
