"""Frequency-space (group-space) advection for comoving-frame MGFLD
radiation hydrodynamics (counterpart of `castro_tpu/radiation/fspace.py`).

In the comoving frame the radiation energy density is advected in
log-frequency space with a speed set by the local velocity gradients
(Krumholz et al. paper III, Sec 2.4). The reference implements this as a
per-zone 1D finite-volume advection over the group index with MC-limited
HLL fluxes and SSP-RK3 time integration, CFL-subcycled
(`Source/radiation/RadHydro.H:98-293` `dudt`/`update_one_species`), driven
from the conservative radiation update (`Source/hydro/Castro_ctu_rad.cpp:
212-325`: the advection speed `af[g] = -(f1*divu + f2*nn:grad u)` and the
`Erscale` group measure).

The whole grid advances at once: arrays are `[ngroups, *spatial]` and
every group-axis stencil is a slice. The per-zone subcycle count depends
on the data; each zone takes dt = tend/nstep(zone) and all zones march in
a masked loop to the global maximum, read once on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CFL_FSPACE = 0.5  # reference RadHydro.H:10
_TINY = 1.0e-50


def group_structure(ngroups, lowest_hz, highest_hz=None, grow_factor=-1.0,
                    first_group_width_hz=-1.0):
    """Frequency-group layout (reference `RadMultiGroup.cpp:24-85`):
    geometric widths from `first_group_width_hz` when `grow_factor > 0`
    (the first group anchored at nu = 0 when `lowest_hz == 0`), else
    log-uniform between lowest_hz and highest_hz. Returns a dict of float64
    numpy arrays: xnu [ng+1], nugroup [ng], dnugroup [ng], dlognu [ng]."""
    ng = int(ngroups)
    xnu = np.zeros(ng + 1)
    nugroup = np.zeros(ng)
    dnugroup = np.zeros(ng)
    dlognu = np.zeros(ng)
    if grow_factor > 0.0:
        xnu[0] = lowest_hz
        dnugroup[0] = first_group_width_hz
        xnu[1] = xnu[0] + dnugroup[0]
        if lowest_hz == 0.0:
            nugroup[0] = 0.5 * dnugroup[0]
            dlognu[0] = 2.0 * (math.log(xnu[1]) - math.log(nugroup[0]))
        else:
            nugroup[0] = math.sqrt(xnu[0] * xnu[1])
            dlognu[0] = math.log(xnu[1]) - math.log(xnu[0])
        for i in range(1, ng):
            dnugroup[i] = dnugroup[i - 1] * grow_factor
            xnu[i + 1] = xnu[i] + dnugroup[i]
            nugroup[i] = math.sqrt(xnu[i] * xnu[i + 1])
            dlognu[i] = math.log(xnu[i + 1]) - math.log(xnu[i])
    else:
        llo = math.log10(lowest_hz)
        lhi = math.log10(highest_hz)
        dl = (lhi - llo) / ng
        for i in range(ng + 1):
            xnu[i] = 10.0 ** (llo + i * dl)
        for i in range(ng):
            nugroup[i] = 10.0 ** (llo + (i + 0.5) * dl)
            dnugroup[i] = xnu[i + 1] - xnu[i]
            dlognu[i] = math.log(xnu[i + 1]) - math.log(xnu[i])
    return dict(xnu=xnu, nugroup=nugroup, dnugroup=dnugroup, dlognu=dlognu)


def _mc(r):
    """MC limiter (reference RadHydro.H:46-50)."""
    return torch.clamp(torch.clamp(torch.minimum(2.0 * r, 0.5 * (1.0 + r)), max=2.0), min=0.0)


def _tiny(dtype):
    """The reference's 1e-50 ratio guard, raised to the smallest normal of
    the working dtype: in float32 a literal 1e-50 flushes to zero and the
    0/0 ratios turn to NaN."""
    return max(_TINY, float(torch.finfo(dtype).tiny))


def _extend(u, a):
    """Ghost groups at each end of the group axis (reference
    RadHydro.H:113-130): u mirrored, the speed mirrored with a sign flip
    (so that the interface speed vanishes at the ends of the spectrum)."""
    ug = torch.cat([u[1:2], u[0:1], u, u[-1:], u[-2:-1]], dim=0)
    ag = torch.cat([-a[1:2], -a[0:1], a, -a[-1:], -a[-2:-1]], dim=0)
    return ug, ag


def dudt_fspace(u, a, dlognu):
    """Advection right-hand side over the group axis (reference
    RadHydro.H:98-189, MUSCL branch): MC-limited left/right states of u and
    of the speed a, the HLL flux at the interior group interfaces, zero
    flux at the ends of the spectrum. u, a: [ng, *spatial]; dlognu: [ng]
    tensor of cell widths."""
    n = u.shape[0]
    U, A = _extend(u, a)
    dU = U[1:] - U[:-1]
    dA = A[1:] - A[:-1]
    eps = _tiny(u.dtype)

    # interior interfaces i = 1..n-1; the extended index of group g is g+2
    rl_u = dU[1:n] / (dU[2:n + 1] + eps)
    ul = U[2:n + 1] + 0.5 * dU[2:n + 1] * _mc(rl_u)
    rl_a = dA[1:n] / (dA[2:n + 1] + eps)
    al = A[2:n + 1] + 0.5 * dA[2:n + 1] * _mc(rl_a)
    fl = al * ul

    rr_u = dU[2:n + 1] / (dU[3:n + 2] + eps)
    ur = U[3:n + 2] - 0.5 * dU[3:n + 2] * _mc(rr_u)
    rr_a = dA[2:n + 1] / (dA[3:n + 2] + eps)
    ar = A[3:n + 2] - 0.5 * dA[3:n + 2] * _mc(rr_a)
    fr = ar * ur

    a_plus = torch.clamp(torch.maximum(al, ar), min=0.0)
    a_minus = torch.clamp(torch.maximum(-al, -ar), min=0.0)
    f_int = (a_plus * fl + a_minus * fr - a_plus * a_minus * (ur - ul)) / (
        a_plus + a_minus + eps)

    zero = torch.zeros_like(u[0:1])
    f = torch.cat([zero, f_int, zero], dim=0)  # [ng+1, ...]
    dl = dlognu.reshape((n,) + (1,) * (u.dim() - 1))
    return (f[:-1] - f[1:]) / dl


def update_one_species(u, a, dlognu, tend):
    """Subcycled SSP-RK3 advance of u in group space by time `tend`
    (reference RadHydro.H:192-293, rk_order=3). Each zone's CFL picks its
    substep dt = tend/nstep; all zones march together in a masked loop to
    the global maximum substep count. Returns (u_new, nstep_max), the
    count a Python int."""
    n = u.shape[0]
    dl = dlognu.reshape((n,) + (1,) * (u.dim() - 1))
    acfl = _tiny(u.dtype) + torch.abs(a)
    dt_cfl = torch.amin(dl / acfl * CFL_FSPACE, dim=0)
    nstep = torch.where(dt_cfl >= tend, torch.ones_like(dt_cfl, dtype=torch.int32),
                        torch.ceil(tend / dt_cfl).to(torch.int32))
    dtz = tend / nstep.to(u.dtype)
    nmax = int(torch.max(nstep))
    third = 1.0 / 3.0

    def rk3(uk):
        u1 = uk + dtz * dudt_fspace(uk, a, dlognu)
        u1 = 0.75 * uk + 0.25 * (u1 + dtz * dudt_fspace(u1, a, dlognu))
        return third * uk + (2.0 * third) * (u1 + dtz * dudt_fspace(u1, a, dlognu))

    for i in range(nmax):
        u = torch.where(i < nstep, rk3(u), u)
    return u, nmax


def advect_in_fspace(Er, af, nugroup, dlognu, dt, fspace_type=1):
    """Advect the group spectrum through log-frequency space (reference
    Castro_ctu_rad.cpp:306-325): rescale Er by the group measure (`Erscale`:
    dlognu for fspace type 1, nu*dlognu for type 2), advect, rescale back.
    Er, af: [ngroups, *spatial]; nugroup, dlognu: float64 arrays, used in
    Er's dtype. Returns (Er_new, nstep_max)."""
    n = Er.shape[0]
    if n <= 1:
        return Er, 1
    shape = (n,) + (1,) * (Er.dim() - 1)
    dlognu = torch.as_tensor(np.asarray(dlognu, np.float64)).to(Er.dtype).to(Er.device)
    nugroup = torch.as_tensor(np.asarray(nugroup, np.float64)).to(Er.dtype).to(Er.device)
    af = af.to(Er.dtype)
    if fspace_type == 1:
        erscale = dlognu.reshape(shape)
    else:
        erscale = (nugroup * dlognu).reshape(shape)
    ustar, nstep = update_one_species(Er / erscale, af, dlognu, dt)
    return ustar * erscale, nstep


def fspace_speeds(divu, nn_colon_gradu, lamc_g, limiter, closure):
    """Group advection speeds af[g] = -(f1 divu + f2 nn:grad u) (reference
    Castro_ctu_rad.cpp:250-253); lamc_g [ngroups, *spatial] the
    cell-centred flux limiters."""
    from castro_tpu_torch.ops.rad_hydro import edd_factor

    eddf = edd_factor(lamc_g, limiter, closure)
    f1 = 0.5 * (1.0 - eddf)
    f2 = 0.5 * (3.0 * eddf - 1.0)
    return -(f1 * divu + f2 * nn_colon_gradu)
