"""Hybrid (radial/angular) momentum advection, castro.hybrid_hydro=1
(counterpart of `castro_tpu/ops/hybrid.py`; reference `Source/hydro/
hybrid.H`, Byerly et al. 2014 Eqs. 25-26, and `Castro_hybrid.cpp`). The
UMR / UML / UMP components are evolved with their own interface fluxes,
conserving angular momentum to round-off, and the linear momenta are
rebuilt from them after each update.
"""

from __future__ import annotations

import torch

from castro_tpu_torch.utils.tmath import vmax

R_MIN = 1.0e-30


def _center(geom, layout):
    return [0.5 * (geom.prob_lo[d] + geom.prob_hi[d]) for d in range(layout.dim)]


def _loc(geom, layout, ng, shape, dtype, face_dir=None):
    """Cell positions relative to the domain centre; with face_dir that
    axis takes the faces (i-1/2 at i)."""
    dim = layout.dim
    cen = _center(geom, layout)
    out = []
    for d in range(3):
        if d >= dim:
            out.append(torch.zeros(shape, dtype=dtype, device=geom.device))
            continue
        x = geom.cell_centers(d, ng)
        if face_dir == d:
            x = x - 0.5 * geom.dx[d]
        out.append(torch.broadcast_to(x, shape).to(dtype) - cen[d])
    return out


def linear_to_hybrid(loc, mom):
    """(px, py, pz) -> (pR, pL, pP) [Byerly Eq. 25-26]."""
    R = vmax(torch.sqrt(loc[0] ** 2 + loc[1] ** 2), R_MIN)
    Rinv = 1.0 / R
    return (mom[0] * loc[0] * Rinv + mom[1] * loc[1] * Rinv,
            mom[1] * loc[0] - mom[0] * loc[1],
            mom[2])


def hybrid_to_linear(loc, hyb):
    R = vmax(torch.sqrt(loc[0] ** 2 + loc[1] ** 2), R_MIN)
    Rinv = 1.0 / R
    return (hyb[0] * loc[0] * Rinv - hyb[1] * loc[1] * Rinv * Rinv,
            hyb[1] * loc[0] * Rinv * Rinv + hyb[0] * loc[1] * Rinv,
            hyb[2])


def hybrid_flux(qe, d, geom, layout, ng):
    """Hybrid-momentum interface fluxes from the Godunov state
    (hybrid.H compute_hybrid_flux), at i-1/2 at i: (F_UMR, F_UML, F_UMP)."""
    L = layout
    rho = qe[L.GDRHO]
    vel = [qe[c] for c in (L.GDU, L.GDV, L.GDW)]
    loc = _loc(geom, L, ng, rho.shape, rho.dtype, face_dir=d)
    mom = [rho * v for v in vel]
    hyb = linear_to_hybrid(loc, mom)
    u_adv = vel[d]
    p = qe[L.GDPRES]
    fr = hyb[0] * u_adv
    fp = hyb[2] * u_adv
    if d == 0:
        fl = hyb[1] * u_adv - loc[1] * p
    elif d == 1:
        fl = hyb[1] * u_adv + loc[0] * p
    else:
        fl = hyb[1] * u_adv
        fp = fp + p
    return fr, fl, fp


def hybrid_geom_source(u, geom, layout, ng):
    """Geometric source on the radial momentum, S_UMR = (1/rho) L^2 / R^3
    (Castro_hybrid.cpp fill_hybrid_hydro_source), as an [NVAR, grid] source."""
    L = layout
    rho = u[L.URHO]
    loc = _loc(geom, L, ng, rho.shape, rho.dtype)
    R = vmax(torch.sqrt(loc[0] ** 2 + loc[1] ** 2), R_MIN)
    src = torch.zeros_like(u)
    src[L.UMR] = (1.0 / rho) * (1.0 / R) ** 3 * u[L.UML] ** 2
    return src


class HybridSource:
    """The hybrid-momentum geometric source of a level (sources/__init__.py)."""

    name = "hybrid"

    def __init__(self, geom, layout, ng):
        self.geom, self.layout, self.ng = geom, layout, ng

    def __call__(self, sim, u, q, qaux, t, dt, ctx=None):
        geom = ctx.geom if ctx is not None else self.geom
        return hybrid_geom_source(u, geom, self.layout, self.ng)


def sync_linear_from_hybrid(u, geom, layout, ng):
    """Overwrite the linear momenta from the (authoritative) hybrid ones
    (Castro_hybrid.cpp hybrid_to_linear_momentum)."""
    L = layout
    loc = _loc(geom, L, ng, u.shape[1:], u.dtype)
    lin = hybrid_to_linear(loc, (u[L.UMR], u[L.UML], u[L.UMP]))
    u = u.clone()
    u[L.UMX], u[L.UMY], u[L.UMZ] = lin
    return u
