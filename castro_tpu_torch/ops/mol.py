"""Method-of-lines hydro: the 2nd-order advective operator without
characteristic tracing (counterpart of `castro_tpu/ops/mol.py`; reference
`construct_mol_hydro_source`, `Source/hydro/Castro_mol_hydro.cpp:20-767`).

`mol_hydro` builds dt-free PLM interface states along each direction,
solves the Riemann problem on every face, adds the flux-based artificial
viscosity, normalizes the species fluxes and returns A(U) = -div F with the
area-over-volume ratios of the geometry, the -p div u term of the internal
energy, and, on a curvilinear grid, the radial pressure gradient that the
radial momentum flux leaves out. The true-SDC integrator of order 2
(`sdc/__init__.py:TrueSDC2`) evaluates it at its nodes; the order-4
integrators use `ops/fourth_order.py:mol4_hydro`.

The Riemann solves go through `riemann.cmpflx` with `cfg.use_kernels`:
for riemann_solver 0 and 2 that is the cmpflx kernel (`ops/kernels.py:
cmpflx`, its plain version on CPU tensors); riemanncg is torch ops.
"""

from __future__ import annotations

import torch

from castro_tpu_torch.geometry import CoordSys
from castro_tpu_torch.ops import advection_util as au
from castro_tpu_torch.ops.flatten import uflatten
from castro_tpu_torch.ops.riemann import cmpflx, mom_flux_has_p
from castro_tpu_torch.ops.slope import uslope
from castro_tpu_torch.ops.stencil import shifted


def _plm_interface_states(q, flatn, d, layout, order=4):
    """dt-free PLM states on the faces normal to d, face i-1/2 at index i:
    qm[i] = q_{i-1} + slope_{i-1}/2, qp[i] = q_i - slope_i/2."""
    sl = uslope(q, flatn[None], 1 + d, order)
    qp = q - 0.5 * sl
    qm = shifted(q + 0.5 * sl, -1, 1 + d)
    return qm, qp


def mol_hydro(u, q, qaux, dt_unused, geom, layout, cfg):
    """Advective RHS A(U) = -div F + geometric terms of grown, ghost-filled
    arrays. Returns (adv [NVAR, ...], fluxes per dim [NVAR, faces], qes per
    dim [NGDNV, faces]); the interior is valid."""
    L = layout
    dim = L.dim
    dx = geom.dx
    grid_shape = tuple(q.shape[1:])

    flatn = uflatten(q, L) if cfg.use_flattening else \
        torch.ones(grid_shape, dtype=q.dtype, device=q.device)
    div_node = au.divu_node(q, dx, L)

    fluxes = []
    qes = []
    for d in range(dim):
        qm, qp = _plm_interface_states(q, flatn, d, L, cfg.plm_iorder * 2)
        f, qe = cmpflx(qm, qp, qaux, d, L, geom.coord, riemann_solver=cfg.riemann_solver,
                       small_dens=cfg.small_dens, small_pres=cfg.small_pres,
                       use_kernels=cfg.use_kernels)
        del qm, qp
        f = au.apply_av(f, d, div_node, u, L, cfg.difmag, dx)
        f = au.normalize_species_fluxes(f, L)
        fluxes.append(f)
        qes.append(qe)

    volinv = 1.0 / geom.volume(cfg.ng)
    adv = torch.zeros_like(u)
    pdivu = torch.zeros(grid_shape, dtype=q.dtype, device=q.device)
    for d in range(dim):
        area = geom.face_area(d, cfg.ng)
        # the ratio area/vol (~1/dx): area * flux overflows float32 in cgs 3D
        av_lo = area * volinv
        av_hi = shifted(area, 1, d) * volinv \
            if (geom.coord != CoordSys.CARTESIAN and d == 0) else av_lo
        adv = adv + (av_lo * fluxes[d] - av_hi * shifted(fluxes[d], 1, 1 + d))
        gdu = qes[d][(L.GDU, L.GDV, L.GDW)[d]]
        gdp = qes[d][L.GDPRES]
        pdivu = pdivu + 0.5 * (shifted(gdp, 1, d) + gdp) * (
            shifted(gdu, 1, d) * av_hi - gdu * av_lo)
    adv[L.UEINT] = adv[L.UEINT] - pdivu
    adv[L.UTEMP] = 0.0
    if not mom_flux_has_p(0, geom.coord):
        gdp0 = qes[0][L.GDPRES]
        adv[L.UMX] = adv[L.UMX] - (shifted(gdp0, 1, 0) - gdp0) / dx[0]
    return adv, fluxes, qes
