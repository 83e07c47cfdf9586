"""Riemann solvers + interface flux assembly.

Counterpart of `castro_tpu/ops/riemann.py` (reference
`Source/hydro/riemann_solvers.H`): the CGF two-shock solver `riemannus`
(:599-817), HLLC (:993+, riemann_solver=2), the flux assembly
`compute_flux_q` (:16-120) with wall masks, and passives upwinded on the
interface velocity (`Source/hydro/riemann.cpp:106-135`), the iterative
Colella-Glaz solver `riemanncg` (:227-599, riemann_solver=1) and the HLLE
flux `hll_flux` (:817+) that `hybrid_riemann` takes inside shocks.
`csrc/riemann.cuh` holds riemannus, HLLC and the flux assembly per face;
riemanncg and the HLL hybrid are torch ops on every device, as they are
XLA ops in the JAX package.

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


def _wsqge(p, tau, gam, gdot, gmin, gmax, csq, pstar):
    """CG approximate Lagrangian wave speed squared + predicted gamma_e
    across the wave (reference `wsqge`, riemann.H: CG Eq. 31 & 34)."""
    SMLP1 = 1.0e-10
    gstar = (pstar - p) * gdot / (pstar + p) + gam
    gstar = torch.minimum(torch.maximum(gstar, gmin), gmax)
    alpha = pstar - (gstar - 1.0) * p / (gam - 1.0)
    alpha = _where(alpha == 0.0, SMLP1 * (pstar + p), alpha)
    beta = pstar + 0.5 * (gstar - 1.0) * (pstar + p)
    wsq = (pstar - p) * beta / (tau * alpha)
    wsq = _where(torch.abs(pstar - p) < SMLP1 * (pstar + p), csq, wsq)
    wsq = torch.maximum(wsq, (0.5 * (gam - 1.0) / gam) * csq)
    return wsq, gstar


def riemanncg(ri: RiemannInputs, small_dens, small_pres,
              maxiter=12, cg_tol=1.0e-5) -> GodunovState:
    """The Colella & Glaz (1985) iterative two-shock solver (reference
    `riemanncg`, riemann_solvers.H:227-599): secant iteration on pstar
    with the CG gamma-model wave speeds (`_wsqge`), a fixed count of
    iterations with converged faces frozen, the two-shock estimate as the
    non-convergence fallback (cg_blend=1), and CG contact sampling with
    the interpolated interface gamma_e."""
    WEAKWV = 1.0e-3
    taul = 1.0 / ri.rho_l
    taur = 1.0 / ri.rho_r
    clsql = ri.gamc_l * ri.p_l * ri.rho_l
    clsqr = ri.gamc_r * ri.p_r * ri.rho_r

    # gamma_e built from the interface (rho e)
    gamel = ri.p_l / ri.rhoe_l + 1.0
    gamer = ri.p_r / ri.rhoe_r + 1.0
    gmin = torch.clamp(torch.minimum(gamel, gamer), max=1.0)
    gmax = torch.clamp(torch.maximum(gamel, gamer), min=2.0)
    game_bar = 0.5 * (gamel + gamer)
    gamc_bar = 0.5 * (ri.gamc_l + ri.gamc_r)
    gdot = 2.0 * (1.0 - game_bar / gamc_bar) * (game_bar - 1.0)

    def wsq_l(ps):
        return _wsqge(ri.p_l, taul, gamel, gdot, gmin, gmax, clsql, ps)[0]

    def wsq_r(ps):
        return _wsqge(ri.p_r, taur, gamer, gdot, gmin, gmax, clsqr, ps)[0]

    wsmall = small_dens * ri.csmall
    wl = torch.maximum(wsmall, torch.sqrt(torch.abs(clsql)))
    wr = torch.maximum(wsmall, torch.sqrt(torch.abs(clsqr)))

    # two-shock initial guess
    pstar = ri.p_l + ((ri.p_r - ri.p_l) - wr * (ri.un_r - ri.un_l)) * wl / (wl + wr)
    pstar = torch.clamp(pstar, min=small_pres)
    pstar_two_shock = pstar

    pstar_old = pstar
    wl = torch.sqrt(wsq_l(pstar))
    wr = torch.sqrt(wsq_r(pstar))
    ustar_l = ri.un_l - (pstar - ri.p_l) / wl
    ustar_r = ri.un_r + (pstar - ri.p_r) / wr
    del wl, wr

    # secant iteration (CG Eq. 18)
    converged = torch.zeros_like(pstar, dtype=torch.bool)
    for _ in range(max(maxiter, 2)):
        wl_i = 1.0 / torch.sqrt(wsq_l(pstar))  # inverse wave speeds
        wr_i = 1.0 / torch.sqrt(wsq_r(pstar))
        ustar_r_new = ri.un_r - (ri.p_r - pstar) * wr_i
        ustar_l_new = ri.un_l + (ri.p_l - pstar) * wl_i
        dpditer = torch.abs(pstar_old - pstar)
        zp = torch.abs(ustar_l_new - ustar_l)
        zp = _where(zp - WEAKWV * ri.cavg <= 0.0, dpditer * wl_i, zp)
        zm = torch.abs(ustar_r_new - ustar_r)
        zm = _where(zm - WEAKWV * ri.cavg <= 0.0, dpditer * wr_i, zm)
        denom = dpditer / torch.maximum(zp + zm, SMALL * ri.cavg)
        pstar_new = torch.clamp(pstar - denom * (ustar_r_new - ustar_l_new), min=small_pres)
        err = torch.abs(pstar_new - pstar)
        # converged faces stay as they are (the reference leaves its loop)
        upd = ~converged
        ustar_l = _where(upd, ustar_l_new, ustar_l)
        ustar_r = _where(upd, ustar_r_new, ustar_r)
        pstar_old = _where(upd, pstar, pstar_old)
        pstar = _where(upd, pstar_new, pstar)
        converged = converged | (err < cg_tol * pstar)
    del wl_i, wr_i, ustar_r_new, ustar_l_new, dpditer, zp, zm, denom, pstar_new, err, upd

    # cg_blend=1 fallback: the two-shock estimate where the iteration did
    # not converge (riemann_solvers.H:394)
    pstar = _where(converged, pstar, pstar_two_shock)

    wl_i = 1.0 / torch.sqrt(wsq_l(pstar))
    wr_i = 1.0 / torch.sqrt(wsq_r(pstar))
    ustar_r = ri.un_r - (ri.p_r - pstar) * wr_i
    ustar_l = ri.un_l + (ri.p_l - pstar) * wl_i
    ustar = 0.5 * (ustar_l + ustar_r)
    ustar = _where(torch.abs(ustar) < SMALLU * 0.5 * (torch.abs(ri.un_l) + torch.abs(ri.un_r)),
                   torch.zeros_like(ustar), ustar)

    # contact sampling with the CG gamma model (riemann_solvers.H:460-590)
    one, zero = torch.ones_like(ustar), torch.zeros_like(ustar)
    fp = _where(ustar > 0.0, one, _where(ustar < 0.0, zero, 0.5 * one))
    fm = 1.0 - fp
    uo = fp * ri.un_l + fm * ri.un_r
    po = fp * ri.p_l + fm * ri.p_r
    tauo = fp * taul + fm * taur
    gamco = fp * ri.gamc_l + fm * ri.gamc_r
    gameo = fp * gamel + fm * gamer

    ro = torch.clamp(1.0 / tauo, min=small_dens)
    tauo = 1.0 / ro
    co = torch.maximum(ri.csmall, torch.sqrt(torch.abs(gamco * po * tauo)))
    clsq = (co * ro) ** 2
    wosq, gamstar = _wsqge(po, tauo, gameo, gdot, gmin, gmax, clsq, pstar)

    sgnm = _where(ustar < 0.0, -one, one)
    wo = torch.sqrt(wosq)
    dpjmp = pstar - po
    rstar = 1.0 - ro * dpjmp / wosq
    rstar = torch.clamp(ro / rstar, min=small_dens)
    cstar = torch.maximum(ri.csmall, torch.sqrt(torch.abs(gamco * pstar / rstar)))

    spout = co - sgnm * uo
    spin = cstar - sgnm * ustar
    ushock = wo * tauo - sgnm * uo
    is_shock = dpjmp >= 0.0
    spin = _where(is_shock, ushock, spin)
    spout = _where(is_shock, ushock, spout)
    frac = 0.5 * (1.0 + (spin + spout) / torch.maximum(
        torch.maximum(spout - spin, spin + spout), SMALL * ri.cavg))

    ut = fp * ri.ut_l + fm * ri.ut_r
    utt = fp * ri.utt_l + fm * ri.utt_r

    rho_g = frac * rstar + (1.0 - frac) * ro
    un_g = frac * ustar + (1.0 - frac) * uo
    p_g = frac * pstar + (1.0 - frac) * po
    game_g = frac * gamstar + (1.0 - frac) * gameo

    out = spout < 0.0
    rho_g = _where(out, ro, rho_g)
    un_g = _where(out, uo, un_g)
    p_g = _where(out, po, p_g)
    game_g = _where(out, gameo, game_g)
    star = spin >= 0.0
    rho_g = _where(star, rstar, rho_g)
    un_g = _where(star, ustar, un_g)
    p_g = _where(star, pstar, p_g)
    game_g = _where(star, gamstar, game_g)

    p_g = torch.clamp(p_g, min=small_pres)
    re_g = p_g / (game_g - 1.0)
    return GodunovState(rho=rho_g, un=un_g, ut=ut, utt=utt, p=p_g, rhoe=re_g, ustar=ustar)


def hll_flux(ri: RiemannInputs, d, layout, small_dens, small_pres,
             coord=CoordSys.CARTESIAN):
    """Einfeldt HLLE flux from the interface states (reference `HLL`,
    riemann_solvers.H:817+; `hybrid_riemann` takes it inside shocks), in
    the rotated order [rho, mn, mt1, mt2, E, rhoe]. The pressure enters
    the normal momentum flux only where `mom_flux_has_p`."""
    cl = torch.maximum(ri.csmall, torch.sqrt(torch.abs(ri.gamc_l * ri.p_l / ri.rho_l)))
    cr = torch.maximum(ri.csmall, torch.sqrt(torch.abs(ri.gamc_r * ri.p_r / ri.rho_r)))
    SL = torch.minimum(ri.un_l - cl, ri.un_r - cr)
    SR = torch.maximum(ri.un_l + cl, ri.un_r + cr)
    p_in_mn = 1.0 if mom_flux_has_p(d, coord) else 0.0

    def cons_and_flux(rho, un, ut, utt, p, rhoe):
        E = rhoe + 0.5 * rho * (un ** 2 + ut ** 2 + utt ** 2)
        U = torch.stack([rho, rho * un, rho * ut, rho * utt, E, rhoe])
        F = torch.stack([rho * un, rho * un * un + p_in_mn * p, rho * ut * un,
                         rho * utt * un, un * (E + p), un * rhoe])
        return U, F

    UL, FL = cons_and_flux(ri.rho_l, ri.un_l, ri.ut_l, ri.utt_l, ri.p_l, ri.rhoe_l)
    UR, FR = cons_and_flux(ri.rho_r, ri.un_r, ri.ut_r, ri.utt_r, ri.p_r, ri.rhoe_r)
    SLc = torch.clamp(SL, max=0.0)
    SRc = torch.clamp(SR, min=0.0)
    return (SRc * FL - SLc * FR + SLc * SRc * (UR - UL)) / (SRc - SLc)


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
    if riemann_solver == 1:
        return riemanncg(ri, small_dens, small_pres)
    if riemann_solver == 2:
        return riemann_hllc(ri, small_dens, small_pres)
    raise ValueError(f"riemann_solver={riemann_solver}")


def cmpflx(qm, qp, qaux, d, layout, coord, riemann_solver=0,
           small_dens=1e-200, small_pres=1e-200, bnd_mask=None,
           hybrid_riemann=False, shk=None, use_kernels=False):
    """Riemann solve + flux on every face (reference `cmpflx_plus_godunov`,
    `Source/hydro/riemann.cpp:16`). `bnd_mask` is a WallMask or None. With
    `hybrid_riemann`, faces inside detected shocks (`shk` of either cell
    > 0) take the HLLE flux (carbuncle suppression).

    `use_kernels` sends the pointwise solve of riemann_solver 0 or 2
    through `kernels.cmpflx` (wall masks included); riemanncg and the
    hybrid are torch ops."""
    L = layout
    if use_kernels and not hybrid_riemann and riemann_solver in (0, 2):
        from castro_tpu_torch.ops import kernels as K

        c = qaux[L.QC]
        g = qaux[L.QGAMC]
        return K.cmpflx(qm, qp, shifted(g, -1, d), g, shifted(c, -1, d), c, d, layout,
                        coord, riemann_solver, small_dens, small_pres, bnd_mask=bnd_mask)
    if bnd_mask is not None:
        bnd_mask = bnd_mask.tensor(qm.dtype, qm.device, qm.dim() - 1)
    ri = load_inputs(qm, qp, qaux, d, layout, small_dens)
    gd = solve(ri, riemann_solver, small_dens, small_pres)
    flux, qgdnv = compute_flux(gd, qm, qp, d, layout, coord, bnd_mask=bnd_mask)
    del gd

    if hybrid_riemann and shk is not None:
        shk_face = torch.maximum(shk, shifted(shk, -1, d)) > 0.0
        Fh = hll_flux(ri, d, layout, small_dens, small_pres, coord=coord)
        mom = {0: (L.momentum_index(0), L.UMY, L.UMZ), 1: (L.UMY, L.UMX, L.UMZ),
               2: (L.UMZ, L.UMX, L.UMY)}[d]
        hyb = flux.clone()
        for row, comp in enumerate((L.URHO, *mom, L.UEDEN, L.UEINT)):
            hyb[comp] = Fh[row]
        flux = torch.where(shk_face[None], hyb, flux)
    return flux, qgdnv


class WallMask(NamedTuple):
    """Faces of one normal direction d whose interface velocity is zeroed
    (reference bnd_fac, riemann.cpp:55-61): index `lo` (the lo domain face,
    ng) and `hi` (the hi domain face, n - ng) along d, or -1 for none."""

    d: int
    n: int
    lo: int
    hi: int

    def tensor(self, dtype, device, ndim=3) -> torch.Tensor:
        """The mask as a tensor that broadcasts over an `ndim`-D grid."""
        m = torch.ones(self.n, dtype=dtype, device=device)
        for pos in (self.lo, self.hi):
            if pos >= 0:
                m[pos] = 0.0
        shape = [1] * ndim
        shape[self.d] = self.n
        return m.reshape(shape)
