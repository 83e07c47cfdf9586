"""The gravity source terms (counterpart of `castro_tpu/sources/gravity_src.py`;
reference `Source/gravity/Castro_gravity.cpp`: construct_old/new_gravity
:14,116 and construct_old/new_gravity_source :234,384).

Old time: momentum rho g, energy rho u.g. The new-time correction is the
`corrector` hook: momentum 0.5 (S_new - S_old) with g(U^{n+1}); energy by
castro.grav_source_type, the default type 4 taking the potential-energy
change at zone edges from the step's mass fluxes (Castro_gravity.cpp:
545-585, the gradient form of Springel 2010 Eq. 94), which conserves
rho E + rho phi up to the solver's tolerance."""

from __future__ import annotations

import torch

from castro_tpu_torch.ops.stencil import interior_slice, shifted


def pad_to_grown(arr, ng, dim):
    """Edge-pad an interior array's trailing `dim` axes by ng (the sources
    need NUM_GROW_SRC=3 valid ghosts; the edge clamp is the
    outflow-consistent default)."""
    lead = arr.dim() - dim
    for d in range(dim):
        ax = lead + d
        n = arr.shape[ax]
        idx = torch.arange(-ng, n + ng, device=arr.device).clamp_(0, n - 1)
        arr = arr.index_select(ax, idx)
    return arr


class GravitySource:
    name = "grav"

    def __init__(self, gravity):
        self.gravity = gravity
        self._memo = None  # (u, ctx, g3, phi): one entry, cleared by the step

    def reset(self):
        """Forget the memoized field (the step calls this at its start and
        end, so no field outlives its step or retry)."""
        self._memo = None

    def grav_field(self, sim, u, ctx=None):
        """g [3, grown grid] and phi of the state u.

        Memoized on the tensor u itself (and ctx), with a reference held to
        it: within a step the old-time source and the corrector both need
        g(U^n), and the reference solves exactly twice a step
        (construct_old_gravity + construct_new_gravity)."""
        if self._memo is not None and self._memo[0] is u and self._memo[1] is ctx:
            return self._memo[2], self._memo[3]
        L = sim.layout
        rho_i = u[(L.URHO,) + interior_slice(sim.ng, L.dim, 0)]
        g3, phi = self.gravity.grav_vector(rho_i, ctx)
        out = pad_to_grown(g3, sim.ng, L.dim), phi
        self._memo = (u, ctx, out[0], out[1])
        return out

    def __call__(self, sim, u, q, qaux, t, dt, ctx=None):
        L = sim.layout
        g3, _ = self.grav_field(sim, u, ctx)
        src = torch.zeros_like(u)
        rho = u[L.URHO]
        e_src = 0.0
        for d, comp in enumerate((L.UMX, L.UMY, L.UMZ)):
            src[comp] = rho * g3[d]
            e_src = e_src + u[comp] * g3[d]
        src[L.UEDEN] = e_src
        return src

    def corrector(self, sim, u_old, u_new, t, dt, ctx=None, fluxes=None):
        """The new-time correction (construct_new_gravity_source): momentum
        0.5 (rho_n g_new - rho_o g_old); energy by grav_source_type."""
        L = sim.layout
        UM = (L.UMX, L.UMY, L.UMZ)
        g_old, _ = self.grav_field(sim, u_old, ctx)
        g_new, _ = self.grav_field(sim, u_new, ctx)
        rho_o = u_old[L.URHO]
        rho_n = u_new[L.URHO]

        src = torch.zeros_like(u_new)
        Sr_old = [rho_o * g_old[d] for d in range(3)]
        Sr_new = [rho_n * g_new[d] for d in range(3)]
        mom_corr = []
        for d in range(3):
            corr = 0.5 * (Sr_new[d] - Sr_old[d])
            src[UM[d]] = corr
            mom_corr.append(u_new[UM[d]] + dt * corr)

        SrE_old = sum((u_old[UM[d]] / rho_o) * Sr_old[d] for d in range(3))
        gst = int(sim.params.castro.grav_source_type)
        if gst in (1, 2):
            vn = [(mom_corr[d] if gst == 2 else u_new[UM[d]]) / rho_n for d in range(3)]
            SrE_new = sum(vn[d] * Sr_new[d] for d in range(3))
            SrEcorr = 0.5 * (SrE_new - SrE_old)
        elif gst == 3:
            old_ke = 0.5 * sum(u_new[c] ** 2 for c in UM) / rho_n
            new_ke = 0.5 * sum(m * m for m in mom_corr) / rho_n
            SrEcorr = (new_ke - old_ke) / dt
        else:  # type 4: the edge potential-energy change from the mass fluxes
            SrEcorr = -SrE_old
            if fluxes is not None and sim.params.castro.do_hydro:
                geom = ctx.geom if ctx is not None else sim.geom
                vol = geom.volume(sim.ng)
                for d in range(L.dim):
                    gbar = 0.5 * (g_new[d] + g_old[d])
                    # the time-averaged edge gravity (the gxl/gxr pattern)
                    g_lo = 0.5 * (gbar + shifted(gbar, -1, d))
                    g_hi = 0.5 * (gbar + shifted(gbar, 1, d))
                    F = fluxes[d][L.URHO]  # face-registered: face i-1/2 at i
                    area = geom.face_area(d, sim.ng)
                    # fold area dx/vol (~1) before the flux multiply:
                    # area*flux ~ 1e42 in cgs overflows float32
                    w_lo = area * (geom.dx[d] / vol)
                    if d == 0 and geom.coord != 0:
                        w_hi = shifted(area, 1, d) * (geom.dx[d] / vol)
                    else:
                        w_hi = w_lo
                    F_hi = shifted(F, 1, d)
                    SrEcorr = SrEcorr + 0.5 * (w_lo * F * g_lo + w_hi * F_hi * g_hi)
        src[L.UEDEN] = SrEcorr
        return src
