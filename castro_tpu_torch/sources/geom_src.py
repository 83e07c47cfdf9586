"""The 2D axisymmetric geometric momentum source (counterpart of
`castro_tpu/sources/geom_src.py`; reference `Source/sources/Castro_geom.cpp`,
Bernand-Champmartin): the inertial terms of the azimuthal flow in r-z
geometry, where UMZ carries rho v_theta:

    S(UMR) = rho v_theta^2 / r          (centrifugal)
    S(UM_theta) = -rho u_r v_theta / r  (angular momentum conservation)
"""

from __future__ import annotations

import torch


class GeomSource:
    name = "geom"

    def __init__(self, params, geom, layout, ng):
        self.geom = geom
        self.layout = layout
        self.ng = ng

    def __call__(self, sim, u, q, qaux, t, dt, ctx=None):
        L = self.layout
        geom = ctx.geom if ctx is not None else self.geom
        r = torch.clamp(geom.cell_centers(0, self.ng), min=1e-30)
        rho = u[L.URHO]
        ur = u[L.UMX] / rho
        vth = u[L.UMZ] / rho
        src = torch.zeros_like(u)
        src[L.UMX] = rho * vth * vth / r
        src[L.UMZ] = -rho * ur * vth / r
        return src
