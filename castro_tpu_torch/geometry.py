"""Grid geometry: Cartesian / cylindrical(RZ) / spherical metric factors.

Mirrors the role of AMReX `Geometry` + `Castro::buildMetrics`
(reference `Source/driver/Castro.cpp:740`): cell sizes, face areas and cell
volumes used by the conservative update (`consup_hydro`,
`Source/hydro/Castro_ctu.cpp:12`), including the 2*pi (RZ) and 4*pi
(spherical) solid-angle factors AMReX bakes into volumes/areas.

Metric arrays are 1D profiles broadcast-shaped to the grid. Counterpart of
`castro_tpu/geometry.py`, on torch tensors with an explicit device.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


class CoordSys(enum.IntEnum):
    CARTESIAN = 0
    CYLINDRICAL = 1  # 2D r-z or 1D r
    SPHERICAL = 2  # 1D r


@dataclass(frozen=True)
class Geometry:
    """Uniform-grid geometry for one level.

    A local view (`local_view`) describes a part of the level, an AMR
    window: `n_cell` is its own cell count, `n_global` the level's, and
    `ilo[d]` the level index of its cell 0 along d. Coordinates and metric
    arrays are then correct for its position, and `dx` stays the level's.
    """

    dim: int
    coord: CoordSys
    prob_lo: Tuple[float, ...]
    prob_hi: Tuple[float, ...]
    n_cell: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")
    n_global: Tuple[int, ...] = None
    ilo: Tuple[int, ...] = None

    @property
    def dx(self) -> Tuple[float, ...]:
        n = self.n_global if self.n_global is not None else self.n_cell
        return tuple((self.prob_hi[d] - self.prob_lo[d]) / n[d] for d in range(self.dim))

    def local_view(self, n_local: Tuple[int, ...], ilo: Tuple[int, ...]) -> "Geometry":
        """The geometry of n_local cells starting at level index ilo."""
        base = self.n_global if self.n_global is not None else self.n_cell
        return Geometry(self.dim, self.coord, self.prob_lo, self.prob_hi, tuple(n_local),
                        self.dtype, self.device, n_global=tuple(base),
                        ilo=tuple(int(i) for i in ilo))

    def _index(self, d: int, lo: int, hi: int) -> np.ndarray:
        """Level indices lo..hi-1 of this view along d, as float64."""
        off = 0 if self.ilo is None else self.ilo[d]
        return np.arange(lo, hi, dtype=np.float64) + off

    def refined(self, ratio: int) -> "Geometry":
        return Geometry(self.dim, self.coord, self.prob_lo, self.prob_hi,
                        tuple(n * ratio for n in self.n_cell), self.dtype,
                        self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    # -- coordinates ------------------------------------------------------
    def cell_centers_1d(self, d: int, ng: int = 0) -> torch.Tensor:
        """Cell-center coordinates along axis d, with ng ghosts."""
        i = self._index(d, -ng, self.n_cell[d] + ng)
        return self._tensor(self.prob_lo[d] + (i + 0.5) * self.dx[d])

    def faces_1d(self, d: int, ng: int = 0) -> torch.Tensor:
        """Face coordinates along axis d (n+1 faces), with ng ghosts."""
        i = self._index(d, -ng, self.n_cell[d] + ng + 1)
        return self._tensor(self.prob_lo[d] + i * self.dx[d])

    def bshape(self, arr: torch.Tensor, axis: int) -> torch.Tensor:
        """Reshape a 1D array to broadcast along spatial `axis` of a
        [..., nx, ny, nz] grid array."""
        shape = [1] * self.dim
        shape[axis] = arr.shape[0]
        return arr.reshape(shape)

    def cell_centers(self, d: int, ng: int = 0) -> torch.Tensor:
        return self.bshape(self.cell_centers_1d(d, ng), d)

    def radius(self, ng: int = 0, center: Tuple[float, ...] = None) -> torch.Tensor:
        """Distance from `center` (default domain center) at cell centers."""
        if center is None:
            center = tuple(0.5 * (self.prob_lo[d] + self.prob_hi[d])
                           for d in range(self.dim))
        r2 = 0.0
        for d in range(self.dim):
            x = self.cell_centers(d, ng) - center[d]
            r2 = r2 + x * x
        return torch.sqrt(r2)

    # -- metric factors ----------------------------------------------------
    def volume(self, ng: int = 0) -> torch.Tensor:
        """Cell volumes, broadcastable to the grid (AMReX CoordSys::Volume)."""
        dx = self.dx
        if self.coord == CoordSys.CARTESIAN:
            return torch.full((1,) * self.dim, float(np.prod(dx)),
                              dtype=self.dtype, device=self.device)
        if self.coord == CoordSys.CYLINDRICAL:
            if self.dim == 3:
                raise ValueError("3D cylindrical not supported (matches reference)")
            rf = self.faces_1d(0, ng)
            dv = math.pi * (rf[1:] ** 2 - rf[:-1] ** 2)
            if self.dim >= 2:
                dv = dv * dx[1]
            return self.bshape(dv, 0)
        if self.coord == CoordSys.SPHERICAL:
            if self.dim != 1:
                raise ValueError("spherical coords are 1D only (matches reference)")
            rf = self.faces_1d(0, ng)
            return self.bshape((4.0 * math.pi / 3.0) * (rf[1:] ** 3 - rf[:-1] ** 3), 0)
        raise ValueError(self.coord)

    def face_area(self, d: int, ng: int = 0) -> torch.Tensor:
        """Face areas for faces normal to axis d, face-registered: index i
        holds the area of face i-1/2."""
        dx = self.dx
        if self.coord == CoordSys.CARTESIAN:
            a = float(np.prod([dx[k] for k in range(self.dim) if k != d])) \
                if self.dim > 1 else 1.0
            return torch.full((1,) * self.dim, a, dtype=self.dtype,
                              device=self.device)
        if self.coord == CoordSys.CYLINDRICAL:
            rf = self.faces_1d(0, ng)
            if d == 0:
                a = 2.0 * math.pi * rf[:-1]
                if self.dim >= 2:
                    a = a * dx[1]
            else:
                a = math.pi * (rf[1:] ** 2 - rf[:-1] ** 2)
            return self.bshape(a, 0)
        if self.coord == CoordSys.SPHERICAL:
            rf = self.faces_1d(0, ng)[:-1]
            return self.bshape(4.0 * math.pi * rf ** 2, 0)
        raise ValueError(self.coord)

    def shift_factor(self, d: int) -> float:
        """dt/dx factor helper."""
        return 1.0 / self.dx[d]


def torch_dtype(name: str) -> torch.dtype:
    """`tpu.dtype` string -> torch dtype."""
    return torch.float64 if name == "float64" else torch.float32


def resolve_device(device=None) -> torch.device:
    """`None` means the card. Without a card, only an explicit
    device="cpu" runs; anything else raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def geometry_from_params(params, dtype=None, device=None) -> Geometry:
    """The geometry of `params` on `device` (None: the card, as
    `resolve_device`)."""
    g = params.geometry
    dim = params.dim
    if dtype is None:
        dtype = torch_dtype(params.tpu.dtype)
    return Geometry(
        dim=dim,
        coord=CoordSys(g.coord_sys),
        prob_lo=tuple(g.prob_lo[:dim]),
        prob_hi=tuple(g.prob_hi[:dim]),
        n_cell=tuple(params.amr.n_cell[:dim]),
        dtype=dtype,
        device=resolve_device(device),
    )
