"""Ideal-MHD level solver: the CTU-CT step (`castro.mhd_ctu=1`, the
default) and the RK2 flux-CT step (`mhd_ctu=0`).

Counterpart of `castro_tpu/mhd/solver.py` (reference `Source/mhd/`: CT
corner-transport-upwind with HLLD, `Castro_mhd.cpp:
construct_ctu_mhd_source`, the edge-EMF averaging of `electric.cpp`, div B
= 0 to round-off), in torch ops as the JAX package leaves it to XLA; no
CUDA kernel carries B (`ops/kernels.py:check_kernel_layout`). `step_ctu`
is the reference's corner-coupled scheme in 3D (12 HLLD solves, 3 rounds
of edge EMFs) with its 2D and 1D reductions; `step_rk2` is MC-limited PLM
+ HLLD + flux-CT (Balsara & Spicer) in SSP-RK2.

Layout: the conserved gas state u [NVAR, grown grid] (the hydro
StateLayout) and face B fields b[d], face i-1/2 at index i, the same length
as the cells. Cell-centred B is the face average. Components d >= dim (Bz
in 2D, By and Bz in 1D) are cell-represented.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from castro_tpu_torch.mhd.hlld import MhdFaceState, fast_speed, hlld
from castro_tpu_torch.ops.stencil import interior_slice, shifted

# (d, t, k) -> the sign of the discrete curl dB_d/dt = -eps_dtk dE_k/dx_t
EPS = {(0, 1, 2): 1, (0, 2, 1): -1, (1, 2, 0): 1, (1, 0, 2): -1, (2, 0, 1): 1, (2, 1, 0): -1}


class MhdState(NamedTuple):
    u: torch.Tensor  # [NVAR, grown]
    b: Tuple[torch.Tensor, ...]  # face-centred B a dimension [grown]


def _mc_slope(a, ax):
    dl = a - shifted(a, -1, ax)
    dr = shifted(a, 1, ax) - a
    dc = 0.5 * (dl + dr)
    mag = torch.minimum(torch.abs(dc), 2.0 * torch.minimum(torch.abs(dl), torch.abs(dr)))
    return torch.where(dl * dr > 0.0, torch.sign(dc) * mag, 0.0)


def _plm_faces(a, ax):
    """(aL, aR) at face i-1/2: left from cell i-1, right from cell i."""
    sl = _mc_slope(a, ax)
    aR = a - 0.5 * sl
    aL = shifted(a, -1, ax) + 0.5 * shifted(sl, -1, ax)
    return aL, aR


def _set_row(a, idx, value):
    """A copy of a with a[idx] = value (the JAX package's a.at[idx].set)."""
    out = a.clone()
    out[idx] = value
    return out


class MhdSolver:
    def __init__(self, sim):
        """sim: a Simulation (its layout, geometry, EOS, config and fill)."""
        self.sim = sim
        self.L = sim.layout
        self.geom = sim.geom

    # -- primitives -----------------------------------------------------------
    def cell_b(self, b):
        """Cell-centred B from the face fields."""
        dim = self.L.dim
        return [0.5 * (b[d] + shifted(b[d], 1, d)) if d < dim else b[d] for d in range(3)]

    def add_magnetic_energy(self, u, b):
        """u with the magnetic energy of the face fields added to rho E: the
        problem hooks set the gas energies only (reference
        Castro::add_magnetic_e, Source/driver/Castro.H:823-850)."""
        u = u.clone()
        u[self.L.UEDEN] = u[self.L.UEDEN] + 0.5 * sum(bb * bb for bb in self.cell_b(b))
        return u

    def prim(self, u, b):
        """EOS-general primitives (reference mhd_util ConsToPrim): the
        pressure and Gamma_1 from the EOS."""
        L = self.L
        rho = torch.clamp(u[L.URHO], min=1e-30)
        vel = [u[c] / rho for c in (L.UMX, L.UMY, L.UMZ)]
        bc = self.cell_b(b)
        rhoe = torch.maximum(u[L.UEINT], 1e-30 * rho)
        xn = u[L.UFS:L.UFS + L.nspec] / rho[None]
        es = self.sim.eos.re(rho=rho, e=rhoe / rho, xn=xn)
        return rho, vel, es.p, rhoe / rho, bc, es.gam1

    # -- one direction's face fluxes -------------------------------------------
    def face_flux(self, u, b, d):
        """HLLD fluxes on the d-faces: (Fgas [NVAR, ...], {t: the flux of
        B_t} for the transverse t)."""
        L = self.L
        dim = L.dim
        rho, vel, p, e, bc, gam1 = self.prim(u, b)
        t1, t2 = [k for k in range(3) if k != d]

        def faces(a):
            return _plm_faces(a, d)

        rhoL, rhoR = faces(rho)
        unL, unR = faces(vel[d])
        ut1L, ut1R = faces(vel[t1])
        ut2L, ut2R = faces(vel[t2])
        pL, pR = faces(p)
        Bt1L, Bt1R = faces(bc[t1])
        Bt2L, Bt2R = faces(bc[t2])
        Bn = b[d] if d < dim else bc[d]  # the exact face value

        gL, gR = faces(gam1)
        g = 0.5 * (gL + gR)  # the face's effective Gamma_1

        def side(rh, un, ut1, ut2, pp, B1, B2, gg):
            rho_f = torch.clamp(rh, min=1e-30)
            p_f = torch.clamp(pp, min=1e-30)
            return MhdFaceState(rho=rho_f, un=un, ut1=ut1, ut2=ut2, p=p_f, Bt1=B1, Bt2=B2,
                                e=p_f / (rho_f * (gg - 1)))

        sl = side(rhoL, unL, ut1L, ut2L, pL, Bt1L, Bt2L, gL)
        sr = side(rhoR, unR, ut1R, ut2R, pR, Bt1R, Bt2R, gR)
        F, SM = hlld(sl, sr, Bn, g)

        # the rotated flux scattered into the conserved layout
        rows = [None] * L.NVAR
        mom = (L.UMX, L.UMY, L.UMZ)
        rows[L.URHO] = F[0]
        rows[mom[d]] = F[1]
        rows[mom[t1]] = F[2]
        rows[mom[t2]] = F[3]
        rows[L.UEDEN] = F[4]
        # internal energy: rho e upwind on SM (the dual-energy aux)
        rows[L.UEINT] = torch.where(SM > 0, sl.rho * sl.e * sl.un, sr.rho * sr.e * sr.un)
        # species: upwind on the contact
        for i in range(L.nspec):
            XL, XR = faces(u[L.UFS + i] / torch.clamp(u[L.URHO], min=1e-30))
            rows[L.UFS + i] = F[0] * torch.where(SM > 0, XL, XR)
        Fgas = torch.stack([torch.zeros_like(rho) if r is None else r for r in rows])
        return Fgas, {t1: F[5], t2: F[6]}

    # -- CT electric fields -------------------------------------------------------
    def emf_update(self, b, FB_all, dt):
        """Flux-CT (Balsara-Spicer) edge EMF averaging and the curl update.
        FB_all[d] = {t: the flux of B_t through d-faces}; with (d, t, k)
        cyclic, F_d(B_t) = B_t u_d - B_d u_t = -E_k."""
        dim = self.L.dim
        dx = self.geom.dx
        if dim == 1:
            return self._b_1d_update(b, FB_all, dt)

        # E_k = -F_d(B_t) = +F_t(B_d) on the edge (d-1/2, t-1/2), the
        # average of the two faces straddling it of each flux
        E = {}
        for d, t, k in [(0, 1, 2), (1, 2, 0), (2, 0, 1)]:
            if d >= dim or t >= dim:
                continue
            Fd_Bt = FB_all[d][t]
            Ft_Bd = FB_all[t][d]
            E[k] = 0.25 * (-(Fd_Bt + shifted(Fd_Bt, -1, t)) + (Ft_Bd + shifted(Ft_Bd, -1, d)))

        b_new = list(b)
        for d in range(dim):
            upd = 0.0
            for t in range(dim):
                if t == d:
                    continue
                k = 3 - d - t
                if k not in E:
                    continue
                upd = upd - EPS[(d, t, k)] * (shifted(E[k], 1, t) - E[k]) / dx[t]
            b_new[d] = b[d] + dt * upd
        if dim == 2:
            # the out-of-plane Bz: cell-centred, the plain flux divergence
            bz = b[2]
            for d in range(2):
                F = FB_all[d][2]
                bz = bz - dt * (shifted(F, 1, d) - F) / dx[d]
            b_new[2] = bz
        return tuple(b_new)

    # -- RK2 flux-CT ----------------------------------------------------------------
    def rhs(self, u, b):
        """L(U) and every direction's B fluxes."""
        FB_all = {}
        dudt = torch.zeros_like(u)
        for d in range(self.L.dim):
            Fgas, FB = self.face_flux(u, b, d)
            FB_all[d] = FB
            dudt = dudt - (shifted(Fgas, 1, 1 + d) - Fgas) / self.geom.dx[d]
        return dudt, FB_all

    def fill_u(self, u, ctx=None, t=0.0):
        return ctx.fill(u, t) if ctx is not None else self.sim._fill(u, t)

    def fill_b_all(self, b):
        """The face fields' ghost fill (`_fill_b`; on a mesh a halo exchange
        of the face fields, queue 1 item 13)."""
        return tuple(self._fill_b(bb, d) for d, bb in enumerate(b))

    def step_rk2(self, state: MhdState, dt, ctx=None):
        """One SSP-RK2 step of MC-limited PLM + HLLD + flux-CT."""
        u, b = state
        u = self.fill_u(u, ctx)
        b = self.fill_b_all(b)

        dudt1, FB1 = self.rhs(u, b)
        u1 = u + dt * dudt1
        b1 = self.emf_update(b, FB1, dt)
        u1 = self._clean(u1, b1, ctx)
        b1 = self.fill_b_all(b1)

        dudt2, FB2 = self.rhs(u1, b1)
        u2 = 0.5 * (u + u1 + dt * dudt2)
        b2h = self.emf_update(b1, FB2, dt)
        b2 = tuple(0.5 * (b[d] + b2h[d]) for d in range(len(b)))
        u2 = self._clean(u2, b2, ctx)
        return MhdState(u2, b2)

    # -- CTU-CT ----------------------------------------------------------------------
    def ctoprim_ext(self, u, b):
        """The extended primitives [NQ+3] (cell-centred B from the face
        averages) and the gas sound speed, as the reference's MHD ctoprim."""
        L = self.L
        rho, vel, p, e, bc, gam1 = self.prim(u, b)
        xn = u[L.UFS:L.UFS + L.nspec] / rho[None]
        es = self.sim.eos.re(rho=rho, e=e, xn=xn)
        comps = [None] * (L.NQ + 3)
        comps[L.QRHO] = rho
        comps[L.QU], comps[L.QV], comps[L.QW] = vel
        comps[L.QPRES] = p
        comps[L.QREINT] = rho * e
        comps[L.QTEMP] = es.T
        comps[L.QGAME] = p / (rho * e) + 1.0
        for i in range(L.nspec):
            comps[L.QFS + i] = xn[i]
        for k in range(3):
            comps[L.NQ + k] = bc[k]
        return torch.stack([torch.zeros_like(rho) if c is None else c for c in comps]), es.cs

    def step_ctu(self, state: MhdState, dt, srcQ=None, keep_fluxes=False, keep_ct=False,
                 ctx=None):
        """One CTU-CT step of any dimension.

        3D: the reference scheme (construct_ctu_mhd_source,
        `Source/mhd/Castro_mhd.cpp:7-724`; Miniati & Martin: 12 HLLD solves
        and 3 rounds of Gardiner-Stone edge EMFs). 2D: its reduction (4
        HLLD solves, 2 EMF rounds, one dt/2 transverse pass; the reference
        has no 2D MHD build). 1D: the characteristic trace and one HLLD
        solve. div B stays at round-off in every dimension.

        keep_fluxes=True also returns the final gas fluxes [NVAR, grown] a
        dimension (the grav_source_type=4 corrector, the AMR flux
        registers); keep_ct=True also the CT data of the AMR registers:
        {"E": {k: edge EMF}, "FB": {(d, c): the flux of the cell-represented
        B_c through d-faces}} (Bz in 2D, By and Bz in 1D)."""
        from castro_tpu_torch.mhd import ctu_ct as cc
        from castro_tpu_torch.ops.advection_util import (apply_av, divu_node,
                                                         normalize_species_fluxes)
        from castro_tpu_torch.ops.flatten import uflatten

        sim = self.sim
        L = self.L
        dim = L.dim
        dx = self.geom.dx
        eos = sim.eos
        small_dens = sim.cfg.small_dens
        small_pres = sim.cfg.small_pres

        u, b = state
        u = self.fill_u(u, ctx)
        b = self.fill_b_all(b)

        qx, cs = self.ctoprim_ext(u, b)
        QMG, UMG = cc.ext_layout(L)

        # flattening: the product of the p-based and the ptot-based
        # coefficients (Castro_mhd.cpp:168-180)
        if sim.cfg.use_flattening and dim > 1:
            flatn = uflatten(qx, L)
            ptot = qx[L.QPRES] + 0.5 * (qx[QMG[0]] ** 2 + qx[QMG[1]] ** 2 + qx[QMG[2]] ** 2)
            flatn = flatn * uflatten(_set_row(qx, L.QPRES, ptot), L)
        elif sim.cfg.use_flattening:
            flatn = uflatten(qx, L)
        else:
            flatn = torch.ones_like(qx[L.QRHO])

        # the interface states a direction (characteristic PLM or PPM)
        qm, qp, ul, ur = {}, {}, {}, {}
        limit_char = bool(getattr(sim.params.castro, "mhd_limit_characteristic", 1))
        use_ppm = sim.params.castro.ppm_type >= 1
        for d in range(dim):
            if use_ppm:
                # PPM (reference mhd_ppm.cpp:509; the reference's default
                # ppm_type=1 selects it for MHD too)
                m, p_ = cc.ppm_mhd(qx, cs, srcQ, flatn, b, d, dt, dx[d], L, eos, small_dens,
                                   small_pres)
            else:
                m, p_ = cc.plm_mhd(qx, cs, srcQ, flatn, b, d, dt, dx[d], L, eos, small_dens,
                                   small_pres, limit_characteristic=limit_char)
            qm[d], qp[d] = m, p_
            ul[d] = cc.prim_to_cons_ext(m, L, eos)
            ur[d] = cc.prim_to_cons_ext(p_, L, eos)

        # MM step 1: the 1D fluxes
        flx1 = {d: cc.hlld_ext(qm[d], qp[d], d, L, eos, small_dens, small_pres)
                for d in range(dim)}

        if dim == 3:
            # MM step 2: the first edge EMFs
            E1 = {k: cc.electric_edge(k, qx, flx1[(k + 1) % 3], flx1[(k + 2) % 3], L)
                  for k in range(3)}
            # MM steps 3-5: corner coupling (6 states, 6 HLLD solves)
            flx_cc = {}
            for d1 in range(3):
                for d2 in range(3):
                    if d2 == d1:
                        continue
                    d3 = 3 - d1 - d2
                    qr2, ql2 = cc.corner_couple(ur[d1], ul[d1], flx1[d2], E1[d1], E1[d3],
                                                d1, d2, d3, dt, dx, L, eos, small_dens)
                    flx_cc[(d1, d2)] = cc.hlld_ext(ql2, qr2, d1, L, eos, small_dens,
                                                   small_pres)
            del flx1, E1
            # MM step 6: the averaged corner fluxes -> the second edge EMFs
            flxavg = {}
            for d in range(3):
                a, c = [x for x in range(3) if x != d]
                flxavg[d] = 0.5 * (flx_cc[(d, a)] + flx_cc[(d, c)])
            E2 = {k: cc.electric_edge(k, qx, flxavg[(k + 1) % 3], flxavg[(k + 2) % 3], L)
                  for k in range(3)}
            # MM steps 7-9: the half-step states and the final fluxes
            flxf = {}
            for d in range(3):
                d1 = (d + 1) % 3
                d2 = (d + 2) % 3
                qrh, qlh = cc.half_step(ur[d], ul[d], flx_cc[(d1, d2)], flx_cc[(d2, d1)],
                                        E2[d], E2[d1], E2[d2], d, d1, d2, dt, dx, L, eos,
                                        small_dens)
                flxf[d] = cc.hlld_ext(qlh, qrh, d, L, eos, small_dens, small_pres)
            del flx_cc, E2
            # MM step 10: the half-time primitives -> the final EMFs
            q2d = cc.prim_half(qx, [flxavg[0], flxavg[1], flxavg[2]], dt, dx, L, eos)
            del flxavg
            E3 = {k: cc.electric_edge(k, q2d, flxf[(k + 1) % 3], flxf[(k + 2) % 3], L)
                  for k in range(3)}
        elif dim == 2:
            # the 2D reduction: the corner Ez from the 1D fluxes, one
            # transverse pass a direction, the final fluxes, the half-time
            # primitives, the final Ez
            Ez1 = cc.electric_edge(2, qx, flx1[0], flx1[1], L)
            flxf = {}
            for d1 in range(2):
                d2 = 1 - d1
                qrt, qlt = cc.transverse_2d(ur[d1], ul[d1], flx1[d2], Ez1, d1, d2, dt, dx, L,
                                            eos, small_dens)
                flxf[d1] = cc.hlld_ext(qlt, qrt, d1, L, eos, small_dens, small_pres)
            q2d = cc.prim_half(qx, [flx1[0], flx1[1]], dt, dx, L, eos)
            E3 = {2: cc.electric_edge(2, q2d, flxf[0], flxf[1], L)}
        else:
            # 1D: the characteristic trace already gives the half dt
            flxf = {0: flx1[0]}
            E3 = {}
        del ul, ur, qm, qp

        # flux cleaning: artificial viscosity and species normalization on
        # the gas components (Castro_mhd.cpp:640-660)
        div = divu_node(qx, dx, L)
        for d in range(dim):
            gas = flxf[d][:L.NVAR].clone()
            gas[L.UTEMP] = 0.0
            if L.shock_var:
                gas[L.USHK] = 0.0
            gas = apply_av(gas, d, div, u, L, sim.cfg.difmag, dx)
            gas = normalize_species_fluxes(gas, L)
            flxf[d] = torch.cat([gas, flxf[d][L.NVAR:]], dim=0)

        # the conservative gas update (consup_mhd: no pdivu term, the
        # total-energy fluxes carry the magnetic work)
        u_new = u
        for d in range(dim):
            F = flxf[d][:L.NVAR]
            u_new = u_new + dt * (F - shifted(F, 1, 1 + d)) / dx[d]
        u_new = _set_row(u_new, L.UTEMP, u[L.UTEMP])

        # the face B: the curl of the final edge EMFs with each direction's
        # spacing (the reference uses dt/dx[0] throughout, exact for cubic
        # cells only); the cell-represented components by the plain
        # divergence of their fluxes
        b_new = list(b)
        FB_cell = {}
        for c in range(3):
            if c < dim:
                upd = 0.0
                for t in range(dim):
                    if t == c:
                        continue
                    k = 3 - c - t
                    if k not in E3:
                        continue
                    upd = upd - EPS[(c, t, k)] * (shifted(E3[k], 1, t) - E3[k]) / dx[t]
                b_new[c] = b[c] + dt * upd
            else:
                bc_new = b[c]
                for d in range(dim):
                    F = flxf[d][UMG[c]]
                    FB_cell[(d, c)] = F
                    bc_new = bc_new - dt * (shifted(F, 1, d) - F) / dx[d]
                b_new[c] = bc_new
        b_new = self.fill_b_all(tuple(b_new))

        u_new = self._clean(u_new, b_new, ctx)
        out = (MhdState(u_new, b_new),)
        if keep_fluxes:
            out = out + ([flxf[d][:L.NVAR] for d in range(dim)],)
        if keep_ct:
            out = out + ({"E": E3, "FB": FB_cell},)
        return out if len(out) > 1 else out[0]

    def _clean(self, u, b, ctx=None):
        """MHD clean_state: the density floor, the dual-energy reset with
        the magnetic energy removed (reference add_magnetic_e and its reset,
        `Source/driver/Castro.H:823-850`), the temperature; then the fill."""
        sim = self.sim
        L = self.L
        rho = torch.clamp(u[L.URHO], min=sim.cfg.small_dens)
        ke = 0.5 * (u[L.UMX] ** 2 + u[L.UMY] ** 2 + u[L.UMZ] ** 2) / rho
        bc = self.cell_b(b)
        pb = 0.5 * sum(bb * bb for bb in bc)
        rho_eint = u[L.UEDEN] - ke - pb
        eta2 = sim.params.castro.dual_energy_eta2
        eint = torch.where((rho_eint > 0)
                           & (rho_eint / torch.clamp(u[L.UEDEN], min=1e-300) > eta2),
                           rho_eint, u[L.UEINT])
        eint = torch.maximum(eint, rho * 1e-30)
        xn = u[L.UFS:L.UFS + L.nspec] / rho[None]
        es = sim.eos.re(rho=rho, e=eint / rho, xn=xn)
        u = u.clone()
        u[L.URHO] = rho
        u[L.UEINT] = eint
        u[L.UTEMP] = es.T
        return self.fill_u(u, ctx)

    def _b_1d_update(self, b, FB_all, dt):
        """1D: Bx constant; By and Bz (cell fields in b[1], b[2]) evolve by
        the x flux."""
        out = [b[0]]
        for t in (1, 2):
            F = FB_all[0][t]
            out.append(b[t] - dt * (shifted(F, 1, 0) - F) / self.geom.dx[0])
        return tuple(out)

    def _fill_b(self, bb, d):
        """The ghost fill of one face-B field: `ops/fill.py:fill_face`
        (periodic wrap, outflow clamp, a wall's odd normal and even
        tangential parities, odd at no-slip). Components d >= dim are
        cell-represented and fill as cells (wrap, clamp, even mirror)."""
        from castro_tpu_torch.ops.fill import axis_fill_index, fill_face

        sim = self.sim
        dim = self.L.dim
        c = sim.params.castro
        if d >= dim:
            for dd in range(dim):
                idx = axis_fill_index(bb.shape[dd], sim.ng, c.lo_bc[dd], c.hi_bc[dd])
                bb = torch.index_select(bb, dd, torch.as_tensor(idx, device=bb.device))
            return bb
        return fill_face(bb, d, dim, sim.ng, c.lo_bc, c.hi_bc)

    # -- diagnostics ----------------------------------------------------------------
    def div_b(self, b):
        """The cell-centred divergence of the face field (0 to round-off)."""
        out = 0.0
        for d in range(self.L.dim):
            out = out + (shifted(b[d], 1, d) - b[d]) / self.geom.dx[d]
        return out

    def estdt(self, u, b, cfl):
        """The fast-magnetosonic CFL dt over the interior (estdt_mhd,
        timestep.cpp:148), a 0-d tensor."""
        L = self.L
        rho, vel, p, e, bc, gam1 = self.prim(u, b)
        inner = interior_slice(self.sim.ng, L.dim, 0)
        dt = None
        for d in range(L.dim):
            cf = fast_speed(rho, p, bc[d], bc[(d + 1) % 3], bc[(d + 2) % 3], gam1)
            sp = (torch.abs(vel[d]) + cf)[inner]
            dd = torch.min(self.geom.dx[d] / sp)
            dt = dd if dt is None else torch.minimum(dt, dd)
        return cfl * dt
