"""Hydro support: cons<->prim, divergence, artificial viscosity,
species-flux normalization, the Courant check.

Counterpart of `castro_tpu/ops/advection_util.py` (reference
`Source/hydro/advection_util.cpp`: ctoprim :27, shock :204, divu :367,
apply_av :483, normalize_species_fluxes :578, and the positivity and
speed flux limiters :662, :897).
"""

from __future__ import annotations

import torch

from castro_tpu_torch.ops.stencil import interior_slice, shifted


def ctoprim(u, layout, eos, small_dens=1e-200, small_temp=1e-200, Er=None, lam=None,
            rad_limiter=2, rad_closure=3):
    """Conserved -> primitive (+ aux thermodynamics): (q[NQ], qaux[NQAUX]).
    Assumes a cleaned `u` (reference `ctoprim`, advection_util.cpp:27).
    On a radiation layout, with the grown Er and lambda [ngroups, grid],
    it fills QRAD, QPTOT, QREITOT, the gas gamc and c (QGAMCG, QCG), the
    limiters (QLAMS) and the total gamc and sound speed
    (advection_util.cpp:163-192); without them those slots are zero, as
    the JAX package's zero-initialized arrays leave them on the
    operator-split path."""
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
    if L.mhd:
        # the MHD layout's magnetic and total-pressure slots, zero as in
        # the JAX package's arrays (the MHD step builds its own extended
        # primitives, mhd/solver.py:ctoprim_ext)
        zero = torch.zeros_like(rho)
        for c in (L.QMAGX, L.QMAGY, L.QMAGZ, L.QPTOT):
            q[c] = zero
    if L.radiation:
        zero = torch.zeros_like(rho)
        for c in [L.QPTOT, L.QREITOT] + [L.QRAD + g for g in range(L.ngroups)]:
            q[c] = zero
        for c in [L.QGAMCG, L.QCG] + [L.QLAMS + g for g in range(L.ngroups)]:
            qaux[c] = zero
    if L.radiation and Er is not None:
        from castro_tpu_torch.ops.rad_hydro import compute_ptot_ctot

        # a problem may hand in float64 Er or lambda in a float32 run
        Er = Er.to(rho.dtype)
        lam = lam.to(rho.dtype)
        for g in range(L.ngroups):
            q[L.QRAD + g] = Er[g]
            qaux[L.QLAMS + g] = lam[g]
        qaux[L.QGAMCG] = es.gam1
        qaux[L.QCG] = es.cs
        q = torch.stack(q)
        ptot, ctot, gamc_tot = compute_ptot_ctot([lam[g] for g in range(L.ngroups)], q, es.cs,
                                                 L, comoving=True, limiter=rad_limiter,
                                                 closure=rad_closure)
        q[L.QPTOT] = ptot
        q[L.QREITOT] = q[L.QREINT] + torch.sum(Er, dim=0)
        qaux[L.QC] = ctot
        qaux[L.QGAMC] = gamc_tot
        return q, torch.stack(qaux)
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
    # summed in species order, as the kernels sum them
    sumn = flux[L.UFS]
    for k in range(1, L.nspec):
        sumn = sumn + flux[L.UFS + k]
    one = torch.ones_like(sumn)
    fac = torch.where(sumn != 0.0,
                      flux[L.URHO] / torch.where(sumn == 0.0, one, sumn), one)
    out = flux.clone()
    out[L.UFS: L.UFS + L.nspec] = flux[L.UFS: L.UFS + L.nspec] * fac[None]
    return out


def _cell_flux(u, q, d, coord, layout):
    """Cell-centred flux vector in direction d from the cell's conserved
    and primitive states (reference `dflux`, advection_util.H:12), for the
    Lax-Friedrichs flux of the limiters."""
    from castro_tpu_torch.ops.riemann import mom_flux_has_p

    L = layout
    v = q[L.velocity_index(d)]
    f = torch.zeros_like(u)
    for c in (L.URHO, L.UMX, L.UMY, L.UMZ, L.UEINT):
        f[c] = u[c] * v
    f[L.UEDEN] = (u[L.UEDEN] + q[L.QPRES]) * v
    if mom_flux_has_p(d, coord):
        m = L.momentum_index(d)
        f[m] = f[m] + q[L.QPRES]
    for c in range(L.UFS, L.UFS + L.nspec + L.naux):
        f[c] = u[c] * v
    return f


def _shift_maybe(a, off, axis):
    """Shift a broadcast-shaped metric array only along non-degenerate axes."""
    return shifted(a, off, axis) if a.shape[axis] > 1 else a


def _lf_setup(d, u, q, geom, layout, dt, cfl, ng):
    """The pieces both Hu-Adams-Shu limiters share: the left and right cell
    states, the Lax-Friedrichs flux and each side's update coefficient."""
    L = layout
    ax = 1 + d
    uL = shifted(u, -1, ax)
    uR = u
    fL = _cell_flux(uL, shifted(q, -1, ax), d, geom.coord, L)
    fR = _cell_flux(uR, q, d, geom.coord, L)
    alpha = 1.0 / L.dim
    dtdx = dt / geom.dx[d]
    fluxLF = 0.5 * (fL + fR + (cfl / dtdx / alpha) * (uL - uR))
    area = geom.face_area(d, ng)
    vol = geom.volume(ng)
    coefR = 2.0 * (dt / alpha) * area / vol
    coefL = 2.0 * (dt / alpha) * area / _shift_maybe(vol, -1, d)
    return uL, uR, fluxLF, coefL, coefR


def _safe_div(a, b):
    tiny = torch.finfo(a.dtype).tiny
    guard = torch.where(b < 0, torch.full_like(b, -tiny), torch.full_like(b, tiny))
    return a / torch.where(torch.abs(b) < tiny, guard, b)


def _zero_unfluxed(out, layout):
    out[layout.UTEMP] = 0.0
    if layout.shock_var:
        out[layout.USHK] = 0.0
    return out


def limit_hydro_fluxes_on_small_dens(flux, d, u, q, geom, layout, dt, cfl, small_dens, ng):
    """Positivity-preserving flux limiter (Hu, Adams & Shu 2013 as the
    reference adapts it, advection_util.cpp:662): blend each face flux
    toward the Lax-Friedrichs flux so that no single face update pushes a
    density below the padded floor, then scale as a backstop."""
    L = layout
    density_floor = small_dens * 1.1 * 2 * L.dim
    uL, uR, fluxLF, coefL, coefR = _lf_setup(d, u, q, geom, L, dt, cfl, ng)
    rhoL0 = uL[L.URHO]
    rhoR0 = uR[L.URHO]
    rhoL = rhoL0 - coefL * flux[L.URHO]
    rhoR = rhoR0 + coefR * flux[L.URHO]
    rhoLF_L = rhoL0 - coefL * fluxLF[L.URHO]
    rhoLF_R = rhoR0 + coefR * fluxLF[L.URHO]
    thetaL = _safe_div(density_floor - rhoLF_L, rhoL - rhoLF_L)
    thetaR = _safe_div(density_floor - rhoLF_R, rhoR - rhoLF_R)
    one = torch.ones_like(thetaL)
    theta = torch.where(rhoL < density_floor, thetaL,
                        torch.where(rhoR < density_floor, thetaR, one))
    theta = torch.clamp(theta, 0.0, 1.0)
    out = _zero_unfluxed((1.0 - theta)[None] * fluxLF + theta[None] * flux, L)

    # backstop: scale the final flux so that the floor cannot be crossed
    drhoR2 = coefR * out[L.URHO]
    drhoL2 = coefL * out[L.URHO]
    scale = torch.where(
        rhoR0 + drhoR2 < density_floor,
        torch.abs(_safe_div(density_floor - rhoR0, drhoR2)),
        torch.where(rhoL0 - drhoL2 < density_floor,
                    torch.abs(_safe_div(density_floor - rhoL0, drhoL2)), one))
    out = out * scale[None]
    # a side already below the floor: no flux until a reset
    bad = (rhoL0 < density_floor) | (rhoR0 < density_floor)
    return torch.where(bad[None], torch.zeros_like(out), out)


def limit_hydro_fluxes_on_large_vel(flux, d, u, q, geom, layout, dt, cfl, speed_limit, ng):
    """The velocity analog of the density limiter (reference
    advection_util.cpp:897): blend toward Lax-Friedrichs where a face
    update would push |rho u| past rho * speed_limit."""
    if speed_limit <= 0.0:
        return flux
    L = layout
    uL, uR, fluxLF, coefL, coefR = _lf_setup(d, u, q, geom, L, dt, cfl, ng)
    lim = speed_limit / (2 * L.dim)
    one = torch.ones_like(flux[L.URHO])
    theta = one
    rhoL = uL[L.URHO] - coefL * flux[L.URHO]
    rhoR = uR[L.URHO] + coefR * flux[L.URHO]
    for UM in (L.UMX, L.UMY, L.UMZ):
        rhouL = torch.abs(uL[UM] - coefL * flux[UM])
        rhouR = torch.abs(uR[UM] + coefR * flux[UM])
        rhouLF_L = torch.abs(uL[UM] - coefL * fluxLF[UM])
        rhouLF_R = torch.abs(uR[UM] + coefR * fluxLF[UM])
        thL = torch.abs(_safe_div(rhoL * lim - rhouLF_L, rhouL - rhouLF_L))
        thR = torch.abs(_safe_div(rhoR * lim - rhouLF_R, rhouR - rhouLF_R))
        th = torch.where(rhouL > rhoL * lim, thL, torch.where(rhouR > rhoR * lim, thR, one))
        theta = torch.minimum(theta, th)
    theta = torch.clamp(theta, 0.0, 1.0)
    return _zero_unfluxed((1.0 - theta)[None] * fluxLF + theta[None] * flux, L)


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
