"""State cleaning: density floors, species normalization, dual-energy
reset, temperature computation (counterpart of `castro_tpu/driver/clean.py`).

Reference: `Castro::clean_state` (`Source/driver/Castro.cpp:4238`),
`enforce_min_density`, `normalize_species` (:2902), `reset_internal_energy`
+ `computeTemp` (:3575), dual-energy parameters eta1/eta2
(`Docs/source/FlowChart.rst:89-107`), and the hybrid momenta refreshed
from the linear ones (`update_hybrid_momenta`).
"""

from __future__ import annotations

import torch

from castro_tpu_torch.ops.fill import fill_ghosts
from castro_tpu_torch.ops.stencil import interior_slice


def _full(like, value):
    return torch.full_like(like, value)


def enforce_min_density(u, layout, small_dens, small_temp, eos):
    """Floor density; zones reset to small_dens get zero velocity and
    small_temp internal energy (reference density_reset_method=1 analog)."""
    L = layout
    rho = u[L.URHO]
    bad = rho < small_dens
    rho_new = torch.where(bad, _full(rho, small_dens), rho)
    u = u.clone()
    u[L.URHO] = rho_new
    for c in (L.UMX, L.UMY, L.UMZ):
        u[c] = torch.where(bad, torch.zeros_like(rho), u[c])
    xn = u[L.UFS: L.UFS + L.nspec] / torch.where(bad, rho, rho_new)[None]
    xn = torch.where(bad[None], _full(xn, 1.0 / L.nspec), xn)
    u[L.UFS: L.UFS + L.nspec] = xn * rho_new[None]
    es = eos.rt(rho=rho_new, T=_full(rho, small_temp), xn=xn)
    u[L.UEINT] = torch.where(bad, rho_new * es.e, u[L.UEINT])
    u[L.UEDEN] = torch.where(bad, rho_new * es.e, u[L.UEDEN])
    return u


def normalize_species(u, layout, small_x=1e-30):
    """Clip mass fractions to [small_x, 1] and renormalize to sum 1
    (reference `Castro::normalize_species`, Castro.cpp:2902)."""
    L = layout
    if L.nspec == 0:
        return u
    rho = u[L.URHO]
    rx = torch.minimum(torch.maximum(u[L.UFS: L.UFS + L.nspec],
                                     small_x * rho[None]), rho[None])
    s = torch.sum(rx, dim=0)
    u = u.clone()
    u[L.UFS: L.UFS + L.nspec] = rx * (rho / s)[None]
    return u


def reset_internal_energy(u, layout, eos, dual_energy_eta2=1e-4,
                          small_temp=1e-200):
    """Dual-energy: sync UEINT from UEDEN-KE when trustworthy; rescue
    non-positive UEINT with the small_temp energy."""
    L = layout
    rho = u[L.URHO]
    ke = 0.5 * (u[L.UMX] ** 2 + u[L.UMY] ** 2 + u[L.UMZ] ** 2) / rho
    rho_eint = u[L.UEDEN] - ke
    eint = torch.where(
        (rho_eint > 0.0)
        & (rho_eint / torch.clamp(u[L.UEDEN], min=1e-300) > dual_energy_eta2),
        rho_eint, u[L.UEINT])
    xn = u[L.UFS: L.UFS + L.nspec] / rho[None]
    es_small = eos.rt(rho=rho, T=_full(rho, small_temp), xn=xn)
    rescue = eint <= 0.0
    eint = torch.where(rescue, rho * es_small.e, eint)
    u = u.clone()
    u[L.UEINT] = eint
    u[L.UEDEN] = torch.where(rescue, eint + ke, u[L.UEDEN])
    return u


def compute_temp(u, layout, eos, small_temp=1e-200):
    """T from (rho, e, X) (reference `Castro::computeTemp`, Castro.cpp:3575)."""
    L = layout
    rho = u[L.URHO]
    xn = u[L.UFS: L.UFS + L.nspec] / rho[None]
    es = eos.re(rho=rho, e=u[L.UEINT] / rho, xn=xn)
    u = u.clone()
    u[L.UTEMP] = torch.clamp(es.T, min=small_temp)
    return u


def enforce_speed_limit(u, layout, speed_limit):
    """Cap |v| at castro.speed_limit, removing the corresponding kinetic
    energy (reference Castro::enforce_speed_limit, Castro.cpp:3050)."""
    L = layout
    rho = u[L.URHO]
    rhoinv = 1.0 / rho
    v2 = sum((u[m] * rhoinv) ** 2 for m in (L.UMX, L.UMY, L.UMZ))
    v = torch.sqrt(v2)
    fac = torch.where(v > speed_limit, speed_limit / torch.clamp(v, min=1e-300),
                      torch.ones_like(v))
    ke_old = 0.5 * rho * v2
    u = u.clone()
    for m in (L.UMX, L.UMY, L.UMZ):
        u[m] = u[m] * fac
    u[L.UEDEN] = u[L.UEDEN] - (ke_old - ke_old * fac * fac)
    return u


def clean_state(u, layout, eos, small_dens=1e-200, small_temp=1e-200,
                dual_energy_eta2=1e-4, do_normalize_species=True,
                speed_limit=0.0):
    """The whole ladder in one pass (reference `Castro::clean_state`,
    Castro.cpp:4238): enforce_min_density -> speed limit ->
    normalize_species -> reset_internal_energy -> computeTemp, with every
    component computed once and stacked. `csrc/clean_fill.cu` runs the same
    arithmetic per cell."""
    L = layout
    rho0 = u[L.URHO]
    bad = rho0 < small_dens
    rho = torch.where(bad, _full(rho0, small_dens), rho0)
    zero = torch.zeros_like(rho0)
    mom = [torch.where(bad, zero, u[c]) for c in (L.UMX, L.UMY, L.UMZ)]

    if L.nspec > 0:
        xn = u[L.UFS: L.UFS + L.nspec] / torch.where(bad, rho0, rho)[None]
        xn = torch.where(bad[None], _full(xn, 1.0 / L.nspec), xn)
    else:
        xn = u.new_zeros((0,) + rho.shape)
    es_floor = eos.rt(rho=rho, T=_full(rho, small_temp), xn=xn)
    ueint = torch.where(bad, rho * es_floor.e, u[L.UEINT])
    ueden = torch.where(bad, rho * es_floor.e, u[L.UEDEN])

    if speed_limit > 0.0:
        rhoinv = 1.0 / rho
        v2 = sum((m * rhoinv) ** 2 for m in mom)
        v = torch.sqrt(v2)
        fac = torch.where(v > speed_limit,
                          speed_limit / torch.clamp(v, min=1e-300),
                          torch.ones_like(v))
        ke_old = 0.5 * rho * v2
        mom = [m * fac for m in mom]
        ueden = ueden - (ke_old - ke_old * fac * fac)

    if do_normalize_species and L.nspec > 0:
        rx = torch.minimum(torch.maximum(xn * rho[None], 1e-30 * rho[None]),
                           rho[None])
        s = rx[0]
        for k in range(1, L.nspec):  # in species order, as clean_fill.cu sums
            s = s + rx[k]
        rxn = rx * (rho / s)[None]
        xn2 = rxn / rho[None]
    else:
        rxn = xn * rho[None]
        xn2 = xn

    ke = 0.5 * (mom[0] ** 2 + mom[1] ** 2 + mom[2] ** 2) / rho
    rho_eint = ueden - ke
    eint = torch.where(
        (rho_eint > 0.0)
        & (rho_eint / torch.clamp(ueden, min=1e-300) > dual_energy_eta2),
        rho_eint, ueint)
    es_small = eos.rt(rho=rho, T=_full(rho, small_temp), xn=xn2)
    rescue = eint <= 0.0
    eint = torch.where(rescue, rho * es_small.e, eint)
    ueden = torch.where(rescue, eint + ke, ueden)

    es = eos.re(rho=rho, e=eint / rho, xn=xn2)
    T = torch.clamp(es.T, min=small_temp)

    comps = [None] * L.NVAR
    comps[L.URHO] = rho
    comps[L.UMX], comps[L.UMY], comps[L.UMZ] = mom
    comps[L.UEINT] = eint
    comps[L.UEDEN] = ueden
    comps[L.UTEMP] = T
    for i in range(L.nspec):
        comps[L.UFS + i] = rxn[i]
    for i, cval in enumerate(comps):
        if cval is None:
            comps[i] = u[i]
    return torch.stack(comps)


def update_hybrid_momenta(u, layout, geom, ng):
    """Keep the hybrid momenta (radial/angular/perpendicular about the
    domain centre, reference `Source/hydro/hybrid.H:1-162`
    linear_to_hybrid) consistent with the linear momenta: without
    hybrid_hydro they are derived fields, refreshed every clean."""
    L = layout
    if not L.hybrid_momentum:
        return u
    dim = L.dim
    center = [0.5 * (geom.prob_lo[d] + geom.prob_hi[d]) for d in range(dim)]
    shape = u.shape[1:]
    x = torch.broadcast_to(geom.cell_centers(0, ng) - center[0], shape)
    y = (torch.broadcast_to(geom.cell_centers(1, ng) - center[1], shape)
         if dim > 1 else torch.zeros(shape, dtype=u.dtype, device=u.device))
    px, py, pz = u[L.UMX], u[L.UMY], u[L.UMZ]
    R = torch.clamp(torch.sqrt(x * x + y * y), min=1e-30)
    u = u.clone()
    u[L.UMR] = (x * px + y * py) / R
    u[L.UML] = x * py - y * px
    u[L.UMP] = pz
    return u


def clean_and_fill(u, layout, eos, lo_bc, hi_bc, ng, small_dens, small_temp,
                   dual_energy_eta2, do_normalize_species, with_status=False,
                   speed_limit=0.0, problem_fill=None, t=0.0):
    """`clean_state`, then the ghost fill (and the problem's inflow hook at
    time t). With `with_status` also the interior's minimum density and
    non-finite flag before the clean, as 0-d tensors: (u, min_rho,
    nan_flag). In 3D `ops/kernels.py:clean_fill` does the same in one
    kernel, without speed_limit or a hook."""
    if with_status:
        inner = u[interior_slice(ng, layout.dim)]
        status = (torch.min(inner[layout.URHO]), ~torch.isfinite(torch.sum(inner)))
    out = clean_state(u, layout, eos, small_dens=small_dens, small_temp=small_temp,
                      dual_energy_eta2=dual_energy_eta2,
                      do_normalize_species=do_normalize_species, speed_limit=speed_limit)
    out = fill_ghosts(out, layout, lo_bc, hi_bc, ng, problem_fill=problem_fill, t=t)
    return (out,) + status if with_status else out
