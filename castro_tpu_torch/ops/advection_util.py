"""Hydro support: cons<->prim, divergence, artificial viscosity,
species-flux normalization, the Courant check.

Counterpart of `castro_tpu/ops/advection_util.py` (reference
`Source/hydro/advection_util.cpp`: ctoprim :27, shock :204, divu :367,
apply_av :483, normalize_species_fluxes :578). The flux limiters are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch

from castro_tpu_torch.ops.stencil import interior_slice, shifted


def ctoprim(u, layout, eos, small_dens=1e-200, small_temp=1e-200):
    """Conserved -> primitive (+ aux thermodynamics): (q[NQ], qaux[NQAUX]).
    Assumes a cleaned `u` (reference `ctoprim`, advection_util.cpp:27).
    Radiation is not ported."""
    L = layout
    rho = torch.clamp(u[L.URHO], min=small_dens)
    rhoinv = 1.0 / rho
    vx = u[L.UMX] * rhoinv
    vy = u[L.UMY] * rhoinv
    vz = u[L.UMZ] * rhoinv
    e = torch.maximum(u[L.UEINT], 1e-200 * rho) * rhoinv
    xn = u[L.UFS: L.UFS + L.nspec] * rhoinv[None]
    es = eos.re(rho=rho, e=e, xn=xn)

    q = [None] * L.NQ
    q[L.QRHO] = rho
    q[L.QU], q[L.QV], q[L.QW] = vx, vy, vz
    q[L.QPRES] = es.p
    q[L.QREINT] = rho * e
    q[L.QTEMP] = es.T
    q[L.QGAME] = es.p / (rho * e) + 1.0
    for i in range(L.nspec):
        q[L.QFS + i] = xn[i]
    for i in range(L.naux):
        q[L.QFX + i] = u[L.UFX + i] * rhoinv
    qaux = [None] * L.NQAUX
    qaux[L.QGAMC] = es.gam1
    qaux[L.QC] = es.cs
    qaux[L.QDPDR] = es.dpdr_e
    qaux[L.QDPDE] = es.dpde
    return torch.stack(q), torch.stack(qaux)


def src_to_prim(q, qaux, src, layout):
    """Conserved source terms -> primitive sources for tracing
    (reference `src_to_prim`, `Source/hydro/Castro_ctu_hydro.cpp:315`)."""
    L = layout
    rho = q[L.QRHO]
    rhoinv = 1.0 / rho
    srcq = torch.zeros_like(q)
    srcq[L.QRHO] = src[L.URHO]
    srcq[L.QU] = (src[L.UMX] - q[L.QU] * src[L.URHO]) * rhoinv
    srcq[L.QV] = (src[L.UMY] - q[L.QV] * src[L.URHO]) * rhoinv
    srcq[L.QW] = (src[L.UMZ] - q[L.QW] * src[L.URHO]) * rhoinv
    srcq[L.QREINT] = src[L.UEINT]
    e = q[L.QREINT] * rhoinv
    srcq[L.QPRES] = (qaux[L.QDPDE] * (srcq[L.QREINT] - e * srcq[L.QRHO]) * rhoinv
                     + qaux[L.QDPDR] * srcq[L.QRHO])
    return srcq


def shock(q, dx, layout, threshold=2.0 / 3.0):
    """Multidimensional shock detector (reference `shock`,
    advection_util.cpp:204): 1 in zones with converging flow and a pressure
    jump above `threshold` relative to the local minimum pressure, else 0."""
    L = layout
    p = q[L.QPRES]
    div_u = torch.zeros_like(p)
    for d in range(L.dim):
        vel = q[L.velocity_index(d)]
        div_u = div_u + 0.5 * (shifted(vel, 1, d) - shifted(vel, -1, d)) / dx[d]
    dp2 = torch.zeros_like(p)
    p_min = p
    for d in range(L.dim):
        pp, pm = shifted(p, 1, d), shifted(p, -1, d)
        dp2 = dp2 + (0.5 * (pp - pm)) ** 2
        p_min = torch.minimum(p_min, torch.minimum(pp, pm))
    flagged = (div_u < 0.0) & (torch.sqrt(dp2) / p_min > threshold)
    return flagged.to(p.dtype)


def divu_node(q, dx, layout):
    """Node-centered velocity divergence for artificial viscosity
    (reference `divu`, advection_util.cpp:367). Node (i-1/2,j-1/2,k-1/2)
    is stored at cell index (i,j,k)."""
    L = layout
    dim = L.dim
    out = 0.0
    for d in range(dim):
        vel = q[L.velocity_index(d)]
        dv = (vel - shifted(vel, -1, d)) / dx[d]
        # average over the {0,-1} shifts in the other dims (corner nodes)
        for od in range(dim):
            if od != d:
                dv = 0.5 * (dv + shifted(dv, -1, od))
        out = out + dv
    return out


def apply_av(flux, d, div_node, u, layout, difmag, dx):
    """Flux-based artificial viscosity (reference `apply_av`,
    advection_util.cpp:483): flux += dx*difmag*min(0,div1)*(u_R - u_L) on
    every component except temperature."""
    L = layout
    dim = L.dim
    div1 = div_node
    for od in range(dim):
        if od != d:
            div1 = 0.5 * (div1 + shifted(div1, 1, od))
    coeff = difmag * torch.clamp(div1, max=0.0) * dx[d]
    av = coeff[None] * (u - shifted(u, -1, 1 + d))
    mask = torch.ones((L.NVAR,) + (1,) * dim, dtype=u.dtype, device=u.device)
    mask[L.UTEMP] = 0.0
    if L.shock_var:
        mask[L.USHK] = 0.0
    return flux + mask * av


def normalize_species_fluxes(flux, layout):
    """Scale species fluxes so they sum to the density flux
    (reference `normalize_species_fluxes`, advection_util.cpp:578)."""
    L = layout
    if L.nspec == 0:
        return flux
    sumn = torch.sum(flux[L.UFS: L.UFS + L.nspec], dim=0)
    one = torch.ones_like(sumn)
    fac = torch.where(sumn != 0.0,
                      flux[L.URHO] / torch.where(sumn == 0.0, one, sumn), one)
    out = flux.clone()
    out[L.UFS: L.UFS + L.nspec] = flux[L.UFS: L.UFS + L.nspec] * fac[None]
    return out


def courant_field(q, qaux, dt, dx, layout):
    """Per-cell Courant number max_d (|u_d| + c) dt/dx_d."""
    L = layout
    c = qaux[L.QC]
    courant = torch.zeros_like(c)
    for d in range(L.dim):
        courant = torch.maximum(
            courant, (torch.abs(q[L.velocity_index(d)]) + c) * (dt / dx[d]))
    return courant


def max_courant(q, qaux, dt, geom, layout, ng, whole_grid=False):
    """Max Courant number over all directions (reference
    `check_for_cfl_violation`, Castro_hydro.cpp:234); > 1 means the CTU
    tracing was invalid and the step must be retried. whole_grid=True
    reduces over the grown array, valid whenever ghosts are images of
    interior data (every BC but a problem's inflow)."""
    courant = courant_field(q, qaux, dt, geom.dx, layout)
    if not whole_grid:
        courant = courant[interior_slice(ng, layout.dim, comp_ndim=0)]
    return torch.max(courant)
