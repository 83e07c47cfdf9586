"""Timestep estimators (counterpart of `castro_tpu/driver/timestep.py`;
reference `Source/driver/timestep.cpp`): CFL (:31), burning (:354) and
thermal diffusion (:262). Reductions run over the valid interior only."""

from __future__ import annotations

import math

import torch

from castro_tpu_torch.ops.stencil import interior_slice
from castro_tpu_torch.utils.tmath import vmax


def estdt_cfl(u, layout, eos, geom, ng, cfl):
    """dt = cfl * min over interior zones and dims of dx_d/(|u_d| + c)."""
    L = layout
    ui = u[interior_slice(ng, L.dim, comp_ndim=1)]
    rho = ui[L.URHO]
    rhoinv = 1.0 / rho
    e = ui[L.UEINT] * rhoinv
    xn = ui[L.UFS: L.UFS + L.nspec] * rhoinv[None]
    cs = eos.re(rho=rho, e=e, xn=xn).cs
    dt = None
    for d in range(L.dim):
        vel = torch.abs(ui[L.momentum_index(d)]) * rhoinv
        m = torch.min(geom.dx[d] / (vel + cs))
        dt = m if dt is None else torch.minimum(dt, m)
    return cfl * dt


def estdt_burning(u, layout, eos, network, ng, dtnuc_e, dtnuc_X, dtnuc_X_threshold):
    """Nuclear-burning dt limiters Delta-e/edot and Delta-X/Xdot (reference
    `estdt_burning`, timestep.cpp:354); a Python inf when they are off."""
    L = layout
    if network is None or not network.reactive or (dtnuc_e > 1e199 and dtnuc_X > 1e199):
        return math.inf
    ui = u[interior_slice(ng, L.dim, comp_ndim=1)]
    rho = ui[L.URHO]
    rhoinv = 1.0 / rho
    T = ui[L.UTEMP]
    xn = ui[L.UFS: L.UFS + L.nspec] * rhoinv[None]
    e = ui[L.UEINT] * rhoinv
    xdot, edot = network.rhs(rho, T, xn, e)
    dt = torch.full((), math.inf, dtype=u.dtype, device=u.device)
    if dtnuc_e < 1e199:
        dt = torch.minimum(dt, dtnuc_e * torch.min(e / vmax(torch.abs(edot), 1e-50)))
    if dtnuc_X < 1e199:
        big = xn > dtnuc_X_threshold
        rate = torch.where(big, torch.abs(xdot), torch.zeros_like(xdot))
        dt = torch.minimum(dt, dtnuc_X * torch.min(
            torch.where(big, xn, torch.full_like(xn, math.inf)) / vmax(rate, 1e-50)))
    return dt


def estdt_temp_diffusion(u, layout, eos, geom, ng, diffusion_src):
    """Half the explicit-conduction stability limit dt <= 0.5 dx^2 / D with
    D = k / (rho c_v) (reference `estdt_temp_diffusion`, timestep.cpp:262);
    a Python inf without a diffusion source."""
    if diffusion_src is None:
        return math.inf
    L = layout
    ui = u[interior_slice(ng, L.dim, comp_ndim=1)]
    rho = ui[L.URHO]
    T = ui[L.UTEMP]
    xn = ui[L.UFS: L.UFS + L.nspec] / rho[None]
    es = eos.re(rho=rho, e=ui[L.UEINT] / rho, xn=xn)
    k = diffusion_src.conductivity(rho, T)
    D = k / vmax(rho * es.cv, 1e-300)
    dt = None
    for d in range(L.dim):
        m = torch.min(0.5 * geom.dx[d] ** 2 / vmax(D, 1e-300))
        dt = m if dt is None else torch.minimum(dt, m)
    return 0.5 * dt
