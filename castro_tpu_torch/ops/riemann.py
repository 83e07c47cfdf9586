"""Riemann solvers + interface flux assembly.

Counterpart of `castro_tpu/ops/riemann.py` (reference
`Source/hydro/riemann_solvers.H`): the CGF two-shock solver `riemannus`
(:599-817), HLLC (:993+, riemann_solver=2), the flux assembly
`compute_flux_q` (:16-120) with wall masks, and passives upwinded on the
interface velocity (`Source/hydro/riemann.cpp:106-135`). The iterative
Colella-Glaz solver (riemann_solver=1) and the HLL hybrid wait
(ROADMAP.md). `csrc/riemann.cuh` holds the same solvers per face.

Face convention: face i-1/2 = index i; left state from cell i-1, right
state from cell i.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from castro_tpu_torch.geometry import CoordSys
from castro_tpu_torch.ops.stencil import shifted

SMALL = 1.0e-8
SMALLU = 1.0e-12


def _riemann_vel_map(layout, d):
    """(normal, transverse1, transverse2) primitive velocity components
    (`load_input_states`, riemann.H:64-130)."""
    if d == 0:
        return layout.QU, layout.QV, layout.QW
    if d == 1:
        return layout.QV, layout.QU, layout.QW
    return layout.QW, layout.QU, layout.QV


class RiemannInputs(NamedTuple):
    rho_l: torch.Tensor
    un_l: torch.Tensor
    ut_l: torch.Tensor
    utt_l: torch.Tensor
    p_l: torch.Tensor
    rhoe_l: torch.Tensor
    gamc_l: torch.Tensor
    rho_r: torch.Tensor
    un_r: torch.Tensor
    ut_r: torch.Tensor
    utt_r: torch.Tensor
    p_r: torch.Tensor
    rhoe_r: torch.Tensor
    gamc_r: torch.Tensor
    csmall: torch.Tensor
    cavg: torch.Tensor


class GodunovState(NamedTuple):
    rho: torch.Tensor
    un: torch.Tensor
    ut: torch.Tensor
    utt: torch.Tensor
    p: torch.Tensor
    rhoe: torch.Tensor
    ustar: torch.Tensor  # contact speed, for passive upwinding


def _where(c, a, b):
    return torch.where(c, a, b)


def riemann_inputs(qm, qp, gl, gr, cl, cr, d, layout, small_dens) -> RiemannInputs:
    """Left/right interface states given the left/right cells' gamc and c."""
    L = layout
    QUN, QUT, QUTT = _riemann_vel_map(L, d)
    return RiemannInputs(
        rho_l=torch.clamp(qm[L.QRHO], min=small_dens),
        un_l=qm[QUN], ut_l=qm[QUT], utt_l=qm[QUTT],
        p_l=qm[L.QPRES], rhoe_l=qm[L.QREINT], gamc_l=gl,
        rho_r=torch.clamp(qp[L.QRHO], min=small_dens),
        un_r=qp[QUN], ut_r=qp[QUT], utt_r=qp[QUTT],
        p_r=qp[L.QPRES], rhoe_r=qp[L.QREINT], gamc_r=gr,
        csmall=torch.clamp(SMALL * torch.maximum(cr, cl), min=SMALL),
        cavg=0.5 * (cr + cl),
    )


def load_inputs(qm, qp, qaux, d, layout, small_dens) -> RiemannInputs:
    """Gather left/right interface states (reference `load_input_states`,
    riemann.H:64-130)."""
    L = layout
    c = qaux[L.QC]
    g = qaux[L.QGAMC]
    return riemann_inputs(qm, qp, shifted(g, -1, d), g, shifted(c, -1, d), c,
                          d, layout, small_dens)


def riemannus(ri: RiemannInputs, small_dens, small_pres) -> GodunovState:
    """Colella-Glaz-Ferguson two-shock solver (riemann_solvers.H:599)."""
    wsmall = small_dens * ri.csmall
    wl = torch.maximum(wsmall, torch.sqrt(torch.abs(ri.gamc_l * ri.p_l * ri.rho_l)))
    wr = torch.maximum(wsmall, torch.sqrt(torch.abs(ri.gamc_r * ri.p_r * ri.rho_r)))

    wwinv = 1.0 / (wl + wr)
    pstar = ((wr * ri.p_l + wl * ri.p_r) + wl * wr * (ri.un_l - ri.un_r)) * wwinv
    ustar = ((wl * ri.un_l + wr * ri.un_r) + (ri.p_l - ri.p_r)) * wwinv
    pstar = torch.clamp(pstar, min=small_pres)

    # symmetry preservation: tiny ustar -> 0
    ustar = _where(torch.abs(ustar) < SMALLU * 0.5 * (torch.abs(ri.un_l) + torch.abs(ri.un_r)),
                   torch.zeros_like(ustar), ustar)

    sgnm = torch.sign(ustar)
    fp = 0.5 * (1.0 + sgnm)
    fm = 0.5 * (1.0 - sgnm)

    ro = torch.clamp(fp * ri.rho_l + fm * ri.rho_r, min=small_dens)
    uo = fp * ri.un_l + fm * ri.un_r
    po = fp * ri.p_l + fm * ri.p_r
    reo = fp * ri.rhoe_l + fm * ri.rhoe_r
    gamco = fp * ri.gamc_l + fm * ri.gamc_r

    roinv = 1.0 / ro
    co = torch.maximum(ri.csmall, torch.sqrt(torch.abs(gamco * po * roinv)))
    co2inv = 1.0 / (co * co)

    ut = fp * ri.ut_l + fm * ri.ut_r
    utt = fp * ri.utt_l + fm * ri.utt_r

    drho = (pstar - po) * co2inv
    rstar = torch.clamp(ro + drho, min=small_dens)
    entho = (reo + po) * roinv * co2inv
    estar = reo + (pstar - po) * entho
    cstar = torch.maximum(ri.csmall, torch.sqrt(torch.abs(gamco * pstar / rstar)))

    spout = co - sgnm * uo
    spin = cstar - sgnm * ustar
    ushock = 0.5 * (spin + spout)
    is_shock = pstar - po > 0.0
    spin = _where(is_shock, ushock, spin)
    spout = _where(is_shock, ushock, spout)

    scr = _where(spout - spin == 0.0, SMALL * ri.cavg, spout - spin)
    frac = torch.clamp(0.5 * (1.0 + (spout + spin) / scr), 0.0, 1.0)

    rho_g = frac * rstar + (1.0 - frac) * ro
    un_g = frac * ustar + (1.0 - frac) * uo
    p_g = frac * pstar + (1.0 - frac) * po
    re_g = frac * estar + (1.0 - frac) * reo

    out = spout < 0.0  # outer state on the interface
    rho_g = _where(out, ro, rho_g)
    un_g = _where(out, uo, un_g)
    p_g = _where(out, po, p_g)
    re_g = _where(out, reo, re_g)
    star = spin >= 0.0  # star state on the interface
    rho_g = _where(star, rstar, rho_g)
    un_g = _where(star, ustar, un_g)
    p_g = _where(star, pstar, p_g)
    re_g = _where(star, estar, re_g)

    p_g = torch.clamp(p_g, min=small_pres)
    return GodunovState(rho=rho_g, un=un_g, ut=ut, utt=utt, p=p_g, rhoe=re_g, ustar=ustar)


def riemann_hllc(ri: RiemannInputs, small_dens, small_pres) -> GodunovState:
    """HLLC interface state (reference HLLC, riemann_solvers.H:993), as a
    sampled state so the same flux assembly applies."""
    cl = torch.maximum(ri.csmall, torch.sqrt(torch.abs(ri.gamc_l * ri.p_l / ri.rho_l)))
    cr = torch.maximum(ri.csmall, torch.sqrt(torch.abs(ri.gamc_r * ri.p_r / ri.rho_r)))

    wl = torch.maximum(small_dens * ri.csmall, torch.sqrt(torch.abs(ri.gamc_l * ri.p_l * ri.rho_l)))
    wr = torch.maximum(small_dens * ri.csmall, torch.sqrt(torch.abs(ri.gamc_r * ri.p_r * ri.rho_r)))
    wwinv = 1.0 / (wl + wr)
    pstar = torch.clamp(((wr * ri.p_l + wl * ri.p_r) + wl * wr * (ri.un_l - ri.un_r)) * wwinv,
                        min=small_pres)

    def q_fac(p, gamc):
        r = pstar / p
        return _where(r > 1.0, torch.sqrt(1.0 + (gamc + 1.0) / (2.0 * gamc) * (r - 1.0)),
                      torch.ones_like(r))

    sl = ri.un_l - cl * q_fac(ri.p_l, ri.gamc_l)
    sr = ri.un_r + cr * q_fac(ri.p_r, ri.gamc_r)
    sm = (ri.p_r - ri.p_l + ri.rho_l * ri.un_l * (sl - ri.un_l)
          - ri.rho_r * ri.un_r * (sr - ri.un_r)) / (
        ri.rho_l * (sl - ri.un_l) - ri.rho_r * (sr - ri.un_r))

    def star(rho, un, p, rhoe, s):
        f = rho * (s - un) / (s - sm)
        p_s = p + rho * (un - s) * (un - sm)
        re_s = (rhoe / rho + (sm - un) * (sm + p / (rho * (s - un)))) * f
        return f, p_s, re_s

    rho_ls, p_ls, re_ls = star(ri.rho_l, ri.un_l, ri.p_l, ri.rhoe_l, sl)
    rho_rs, p_rs, re_rs = star(ri.rho_r, ri.un_r, ri.p_r, ri.rhoe_r, sr)

    use_l = sl >= 0.0
    use_ls = (sl < 0.0) & (sm >= 0.0)
    use_rs = (sm < 0.0) & (sr > 0.0)

    def pick(lv, ls, rs, rv):
        return _where(use_l, lv, _where(use_ls, ls, _where(use_rs, rs, rv)))

    rho_g = torch.clamp(pick(ri.rho_l, rho_ls, rho_rs, ri.rho_r), min=small_dens)
    un_g = pick(ri.un_l, sm, sm, ri.un_r)
    p_g = torch.clamp(pick(ri.p_l, p_ls, p_rs, ri.p_r), min=small_pres)
    re_g = pick(ri.rhoe_l, re_ls, re_rs, ri.rhoe_r)
    ut = _where(sm >= 0.0, ri.ut_l, ri.ut_r)
    utt = _where(sm >= 0.0, ri.utt_l, ri.utt_r)
    return GodunovState(rho=rho_g, un=un_g, ut=ut, utt=utt, p=p_g, rhoe=re_g, ustar=sm)


def mom_flux_has_p(d: int, coord) -> bool:
    """Pressure belongs in the momentum flux except in the radial direction
    of curvilinear coordinates (reference `mom_flux_has_p`)."""
    return coord == CoordSys.CARTESIAN or d != 0


def compute_flux(gd: GodunovState, qm, qp, d, layout, coord, bnd_mask=None):
    """Assemble conserved flux [NVAR, faces] + Godunov state [NGDNV, faces]."""
    L = layout
    un = gd.un if bnd_mask is None else gd.un * bnd_mask
    frho = gd.rho * un
    zero = torch.zeros_like(frho)

    comps = [None] * L.NVAR
    comps[L.URHO] = frho
    im1 = L.momentum_index(d)
    im2, im3 = {0: (L.UMY, L.UMZ), 1: (L.UMX, L.UMZ), 2: (L.UMX, L.UMY)}[d]
    fm1 = frho * un
    if mom_flux_has_p(d, coord):
        fm1 = fm1 + gd.p
    comps[im1] = fm1
    comps[im2] = frho * gd.ut
    comps[im3] = frho * gd.utt

    rhoetot = gd.rhoe + 0.5 * gd.rho * (un * un + gd.ut * gd.ut + gd.utt * gd.utt)
    comps[L.UEDEN] = un * (rhoetot + gd.p)
    comps[L.UEINT] = un * gd.rhoe
    comps[L.UTEMP] = zero
    if L.shock_var:
        comps[L.USHK] = zero

    # passives: upwind on the interface velocity (sign 0 -> average)
    sgnm = torch.sign(un)
    fp = 0.5 * (1.0 + sgnm)
    fm = 0.5 * (1.0 - sgnm)
    npass = L.nspec + L.naux
    for k in range(npass):
        comps[L.UFS + k] = frho * (fp * qm[L.QFS + k] + fm * qp[L.QFS + k])
    for i, cpn in enumerate(comps):
        if cpn is None:
            comps[i] = zero
    flux = torch.stack(comps)

    gcomps = [None] * L.NGDNV
    gcomps[L.GDRHO] = gd.rho
    gd_comp = {0: (L.GDU, L.GDV, L.GDW), 1: (L.GDV, L.GDU, L.GDW),
               2: (L.GDW, L.GDU, L.GDV)}[d]
    gcomps[gd_comp[0]] = un
    gcomps[gd_comp[1]] = gd.ut
    gcomps[gd_comp[2]] = gd.utt
    gcomps[L.GDPRES] = gd.p
    gcomps[L.GDGAME] = gd.p / torch.clamp(gd.rhoe, min=torch.finfo(gd.p.dtype).tiny) + 1.0
    for i, cpn in enumerate(gcomps):
        if cpn is None:
            gcomps[i] = zero
    return flux, torch.stack(gcomps)


def solve(ri: RiemannInputs, riemann_solver, small_dens, small_pres) -> GodunovState:
    if riemann_solver == 0:
        return riemannus(ri, small_dens, small_pres)
    if riemann_solver == 2:
        return riemann_hllc(ri, small_dens, small_pres)
    raise NotImplementedError(
        f"riemann_solver={riemann_solver} is not ported (ROADMAP.md, queue 1 item 4)")


def cmpflx(qm, qp, qaux, d, layout, coord, riemann_solver=0,
           small_dens=1e-200, small_pres=1e-200, bnd_mask=None):
    """Riemann solve + flux on every face (reference `cmpflx_plus_godunov`,
    `Source/hydro/riemann.cpp:16`). `bnd_mask` is a WallMask or None."""
    if bnd_mask is not None:
        bnd_mask = bnd_mask.tensor(qm.dtype, qm.device)
    ri = load_inputs(qm, qp, qaux, d, layout, small_dens)
    gd = solve(ri, riemann_solver, small_dens, small_pres)
    return compute_flux(gd, qm, qp, d, layout, coord, bnd_mask=bnd_mask)


class WallMask(NamedTuple):
    """Faces of one normal direction d whose interface velocity is zeroed
    (reference bnd_fac, riemann.cpp:55-61): index `lo` (the lo domain face,
    ng) and `hi` (the hi domain face, n - ng) along d, or -1 for none."""

    d: int
    n: int
    lo: int
    hi: int

    def tensor(self, dtype, device) -> torch.Tensor:
        m = torch.ones(self.n, dtype=dtype, device=device)
        for pos in (self.lo, self.hi):
            if pos >= 0:
                m[pos] = 0.0
        shape = [1, 1, 1]
        shape[self.d] = self.n
        return m.reshape(shape)
