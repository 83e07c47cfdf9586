"""Radiation-hydrodynamics characteristic coupling for the CTU scheme
(counterpart of `castro_tpu/ops/rad_hydro.py`).

Reference: `Source/radiation/trace_ppm_rad.cpp` (radiation in the PPM
characteristic eigensystem: total pressure and sound speed, each group's
Er riding the contact family), the RADIATION branches of `riemannus`
(`Source/hydro/riemann_solvers.H:599+`: star states of the total and the
gas systems, upwinded flux limiters), `compute_flux_q` (`riemann.H`: gas
momentum and energy fluxes plus the Eddington-weighted radiation
advective flux), and `Castro::ctu_rad_consup` (`Castro_ctu_rad.cpp`: the
Er flux divergence, the radiation pressure gradient on the momenta with
its kinetic energy, and the comoving-frame work terms
-(f1 div u + f2 nn:grad u) Er, then frequency-space advection).

`ctu_rad_hydro` couples every geometry characteristically: Cartesian 1D,
2D and 3D, 2D RZ and 1D spherical, gray and multigroup. The JAX package
reaches no Pallas kernel on this path (its step keeps prim_aux and
clean_fill off with radiation, and this chain is XLA end to end), so here
it is torch ops.
"""

from __future__ import annotations

import torch

from castro_tpu_torch.geometry import CoordSys
from castro_tpu_torch.ops.ppm import ppm_int_profile, ppm_int_profile_single, ppm_reconstruct
from castro_tpu_torch.ops.riemann import SMALL, SMALLU, mom_flux_has_p
from castro_tpu_torch.ops.stencil import interior_slice, shifted


def edd_factor(lam, limiter=2, closure=3):
    """Eddington factor f(lambda) (reference fluxlimiter.H Edd_factor; the
    LP family's form in lambda alone)."""
    if closure == 0:
        return lam
    if closure == 1:
        return torch.full_like(lam, 1.0 / 3.0)
    if closure == 2:
        return 1.0 - 2.0 * lam
    if limiter == 0:  # closure 3 without a limiter
        return torch.full_like(lam, 1.0 / 3.0)
    x = torch.clamp(1.0 - 3.0 * lam, min=0.0)
    f = 0.5 * x + torch.sqrt(x * (1.0 + 5.0 * lam))
    return lam + f * f


def _normal_dirs(L, d):
    return {0: (L.QU, L.QV, L.QW), 1: (L.QV, L.QW, L.QU), 2: (L.QW, L.QU, L.QV)}[d]


def compute_ptot_ctot(lam_g, q, cg, layout, comoving=True, limiter=2, closure=3):
    """(ptot, ctot, gamc_tot) from the gas state and each group's (lambda,
    Er) (reference rad_util.H compute_ptot_ctot)."""
    L = layout
    prad = 0.0
    csrad2 = 0.0
    for g in range(L.ngroups):
        er = q[L.QRAD + g]
        lam = lam_g[g]
        gamr = (3.0 - edd_factor(lam, limiter, closure)) / 2.0 if comoving else lam + 1.0
        prad = prad + lam * er
        csrad2 = csrad2 + gamr * (lam * er) / q[L.QRHO]
    ptot = q[L.QPRES] + prad
    ctot2 = cg * cg + csrad2
    return ptot, torch.sqrt(ctot2), ctot2 * q[L.QRHO] / ptot


def trace_ppm_rad(q, qaux, srcQ, flatn, d, dt, dx_d, layout, small_dens, small_pres,
                  dloga=None):
    """Radiation PPM characteristic tracing (trace_ppm_rad.cpp:16-691):
    the acoustic eigensystem acts on the total pressure with the total
    sound speed; the gas pressure evolves with cgas^2 less the
    lambda-weighted radiation jumps; each group's Er rides the contact with
    the enthalpy weight h_r = (lambda+1) Er / rho. `dloga` adds the 1D/2D
    curvilinear geometry source on the x-states (trace_ppm.cpp:567-591,
    with cc the total sound speed). Returns (qm on faces, qp on cells)."""
    L = layout
    ax = d
    ng = L.ngroups
    QUN, QUT, QUTT = _normal_dirs(L, d)

    un = q[QUN]
    cc = qaux[L.QC]        # total sound speed
    csq = cc * cc
    cgassq = qaux[L.QCG] ** 2
    rho = q[L.QRHO]
    p = q[L.QPRES]
    rhoe_g = q[L.QREINT]
    h_g = ((p + rhoe_g) / rho) / csq
    lam0 = [qaux[L.QLAMS + g] for g in range(ng)]
    hr = [(lam0[g] + 1.0) * q[L.QRAD + g] / rho for g in range(ng)]

    dtdx = dt / dx_d
    hdt = 0.5 * dt

    def ppm3(s):
        sm, sp = ppm_reconstruct(s, flatn, ax)
        return ppm_int_profile(sm, sp, s, un, cc, dtdx)

    def ppm1(s):
        sm, sp = ppm_reconstruct(s, flatn, ax)
        return ppm_int_profile_single(sm, sp, s, un, dtdx)

    Ip, Im = {}, {}
    for comp in [L.QRHO, QUN, L.QPRES, L.QREINT, L.QPTOT] + [L.QRAD + g for g in range(ng)]:
        Ip[comp], Im[comp] = ppm3(q[comp])
    Ip_ut, Im_ut = ppm1(q[QUT])
    Ip_utt, Im_utt = ppm1(q[QUTT])

    if srcQ is not None:
        Ip_s, Im_s = {}, {}
        for comp in (L.QRHO, QUN, L.QPRES, L.QREINT):
            Ip_s[comp], Im_s[comp] = ppm3(srcQ[comp])
        Ip_sut, Im_sut = ppm1(srcQ[QUT])
        Ip_sutt, Im_sutt = ppm1(srcQ[QUTT])
    else:
        z = torch.zeros_like(un)
        Ip_s = Im_s = {c: (z, z, z) for c in (L.QRHO, QUN, L.QPRES, L.QREINT)}
        Ip_sut = Im_sut = Ip_sutt = Im_sutt = z

    def build(I, I_ut, I_utt, Isrc, s_ut, s_utt, is_plus):
        r = 0 if is_plus else 2
        rho_ref = torch.clamp(I[L.QRHO][r], min=small_dens)
        un_ref = I[QUN][r]
        p_ref = torch.clamp(I[L.QPRES][r], min=small_pres)
        rhoe_g_ref = I[L.QREINT][r]
        ptot_ref = I[L.QPTOT][r]
        er_ref = [I[L.QRAD + g][r] for g in range(ng)]

        dum = un_ref - I[QUN][0] - hdt * Isrc[QUN][0]
        dptotm = ptot_ref - I[L.QPTOT][0] - hdt * Isrc[L.QPRES][0]
        drho = rho_ref - I[L.QRHO][1] - hdt * Isrc[L.QRHO][1]
        dptot = ptot_ref - I[L.QPTOT][1] - hdt * Isrc[L.QPRES][1]
        drhoe_g = rhoe_g_ref - I[L.QREINT][1] - hdt * Isrc[L.QREINT][1]
        der = [er_ref[g] - I[L.QRAD + g][1] for g in range(ng)]
        dup = un_ref - I[QUN][2] - hdt * Isrc[QUN][2]
        dptotp = ptot_ref - I[L.QPTOT][2] - hdt * Isrc[L.QPRES][2]

        alpham = 0.5 * (dptotm / (rho * cc) - dum) * rho / cc
        alphap = 0.5 * (dptotp / (rho * cc) + dup) * rho / cc
        alpha0r = drho - dptot / csq
        alpha0e_g = drhoe_g - dptot * h_g
        alphar = [der[g] - dptot / csq * hr[g] for g in range(ng)]

        def wside(speed):
            w_minus = 0.5 * (1.0 - torch.sign(speed))
            return w_minus if is_plus else (1.0 - w_minus)

        alpham = -alpham * wside(un - cc)
        alphap = -alphap * wside(un + cc)
        w0 = wside(un)
        alpha0r = -alpha0r * w0
        alpha0e_g = -alpha0e_g * w0
        alphar = [-a * w0 for a in alphar]

        out_rho = torch.clamp(rho_ref + alphap + alpham + alpha0r, min=small_dens)
        out_un = un_ref + (alphap - alpham) * cc / rho
        out_re = rhoe_g_ref + (alphap + alpham) * h_g * csq + alpha0e_g
        out_p = p_ref + (alphap + alpham) * cgassq
        for g in range(ng):
            out_p = out_p - lam0[g] * alphar[g]
        out_p = torch.clamp(out_p, min=small_pres)
        out_ptot = ptot_ref + (alphap + alpham) * csq
        out_er = [er_ref[g] + (alphap + alpham) * hr[g] + alphar[g] for g in range(ng)]
        # negative-group reset (trace_ppm_rad.cpp:432-440)
        out_reitot = out_re
        for g in range(ng):
            neg = out_er[g] < 0.0
            out_ptot = out_ptot + torch.where(neg, -lam0[g] * out_er[g],
                                              torch.zeros_like(out_er[g]))
            out_er[g] = torch.clamp(out_er[g], min=0.0)
            out_reitot = out_reitot + out_er[g]
        return [out_rho, out_un, out_p, out_re, out_ptot, out_reitot, out_er,
                I_ut + hdt * s_ut, I_utt + hdt * s_utt]

    # the plus state (left edge of cell i) takes Im
    qp_vals = build(Im, Im_ut, Im_utt, Im_s, Im_sut, Im_sutt, True)
    qm_vals = build(Ip, Ip_ut, Ip_utt, Ip_s, Ip_sut, Ip_sutt, False)

    if dloga is not None and d == 0:
        # the 1D/2D geometry source on the x-states: only rho, gas p and
        # gas rho e, as the reference's RADIATION build does
        courn = dtdx * (cc + torch.abs(un))
        safe_dloga = torch.where(dloga == 0.0, torch.ones_like(dloga), dloga)
        eta = (1.0 - courn) / (cc * dt * torch.abs(safe_dloga))
        dlogatmp = torch.where(dloga == 0.0, torch.zeros_like(eta),
                               torch.clamp(eta, max=1.0) * dloga)
        sourcr = -0.5 * dt * rho * dlogatmp * un
        sourcp = sourcr * csq
        source = sourcp * ((p + rhoe_g) / rho) / csq
        for vals in (qp_vals, qm_vals):
            vals[0] = torch.clamp(vals[0] + sourcr, min=small_dens)
            vals[2] = vals[2] + sourcp
            vals[3] = vals[3] + source

    passives = list(range(L.QFS, L.QFS + L.nspec + L.naux))
    pass_faces = {}
    for comp in passives:
        pass_faces[comp] = ppm1(q[comp])

    def assemble(vals, is_plus):
        rho_v, un_v, p_v, re_v, ptot_v, reitot_v, er_v, ut_v, utt_v = vals
        comps = [q[i] for i in range(L.NQ)]
        comps[L.QRHO] = rho_v
        comps[QUN] = un_v
        comps[QUT] = ut_v
        comps[QUTT] = utt_v
        comps[L.QPRES] = p_v
        comps[L.QREINT] = re_v
        comps[L.QPTOT] = ptot_v
        comps[L.QREITOT] = reitot_v
        for g in range(ng):
            comps[L.QRAD + g] = er_v[g]
        # the passives ride the contact (as in pure hydro)
        for comp in passives:
            Ipp, Imp = pass_faces[comp]
            comps[comp] = Imp if is_plus else Ipp
        return torch.stack(comps)

    qp_cell = assemble(qp_vals, True)
    qm_face = shifted(assemble(qm_vals, False), -1, 1 + ax)
    return qm_face, qp_cell


def riemannus_rad(qm, qp, qaux, d, layout, small_dens, small_pres):
    """The CGF solver with radiation (riemann_solvers.H RADIATION
    branches): the Godunov interface of the gas and total quantities, as a
    dict."""
    L = layout
    ng = L.ngroups
    ax = d
    QUN, QUT, QUTT = _normal_dirs(L, d)

    c = qaux[L.QC]
    c_m = shifted(c, -1, ax)
    csmall = torch.clamp(SMALL * torch.maximum(c, c_m), min=SMALL)

    rho_l = torch.clamp(qm[L.QRHO], min=small_dens)
    rho_r = torch.clamp(qp[L.QRHO], min=small_dens)
    un_l, un_r = qm[QUN], qp[QUN]
    pt_l, pt_r = qm[L.QPTOT], qp[L.QPTOT]
    ret_l, ret_r = qm[L.QREITOT], qp[L.QREITOT]
    pg_l, pg_r = qm[L.QPRES], qp[L.QPRES]
    reg_l, reg_r = qm[L.QREINT], qp[L.QREINT]
    gamc_l = shifted(qaux[L.QGAMC], -1, ax)
    gamc_r = qaux[L.QGAMC]
    gamcg_l = shifted(qaux[L.QGAMCG], -1, ax)
    gamcg_r = qaux[L.QGAMCG]
    lam_l = [shifted(qaux[L.QLAMS + g], -1, ax) for g in range(ng)]
    lam_r = [qaux[L.QLAMS + g] for g in range(ng)]
    er_l = [qm[L.QRAD + g] for g in range(ng)]
    er_r = [qp[L.QRAD + g] for g in range(ng)]

    wsmall = small_dens * csmall
    wl = torch.maximum(wsmall, torch.sqrt(torch.abs(gamc_l * pt_l * rho_l)))
    wr = torch.maximum(wsmall, torch.sqrt(torch.abs(gamc_r * pt_r * rho_r)))
    wwinv = 1.0 / (wl + wr)
    pstar = torch.clamp(((wr * pt_l + wl * pt_r) + wl * wr * (un_l - un_r)) * wwinv,
                        min=small_pres)
    ustar = ((wl * un_l + wr * un_r) + (pt_l - pt_r)) * wwinv
    ustar = torch.where(torch.abs(ustar) < SMALLU * 0.5 * (torch.abs(un_l) + torch.abs(un_r)),
                        torch.zeros_like(ustar), ustar)
    sgnm = torch.sign(ustar)
    fp = 0.5 * (1.0 + sgnm)
    fm = 0.5 * (1.0 - sgnm)

    ro = torch.clamp(fp * rho_l + fm * rho_r, min=small_dens)
    uo = fp * un_l + fm * un_r
    po = fp * pt_l + fm * pt_r
    gamco = fp * gamc_l + fm * gamc_r
    lam_int = [torch.where(ustar == 0.0,
                           2.0 * lam_l[g] * lam_r[g] / (lam_l[g] + lam_r[g] + 1e-50),
                           fp * lam_l[g] + fm * lam_r[g]) for g in range(ng)]
    po_g = fp * pg_l + fm * pg_r
    reo_r = [fp * er_l[g] + fm * er_r[g] for g in range(ng)]
    po_r = [lam_int[g] * reo_r[g] for g in range(ng)]
    reo_g = fp * reg_l + fm * reg_r
    gamco_g = fp * gamcg_l + fm * gamcg_r

    roinv = 1.0 / ro
    co = torch.maximum(csmall, torch.sqrt(torch.abs(gamco * po * roinv)))
    co2inv = 1.0 / (co * co)
    ut = fp * qm[QUT] + fm * qp[QUT]
    utt = fp * qm[QUTT] + fm * qp[QUTT]

    drho = (pstar - po) * co2inv
    rstar = torch.clamp(ro + drho, min=small_dens)
    estar_g = reo_g + drho * (reo_g + po_g) * roinv
    co_g = torch.maximum(csmall, torch.sqrt(torch.abs(gamco_g * po_g * roinv)))
    pstar_g = torch.clamp(po_g + drho * co_g * co_g, min=small_pres)
    estar_r = [reo_r[g] + drho * (reo_r[g] + po_r[g]) * roinv for g in range(ng)]
    cstar = torch.maximum(csmall, torch.sqrt(torch.abs(gamco * pstar / rstar)))

    spout = co - sgnm * uo
    spin = cstar - sgnm * ustar
    ushock = 0.5 * (spin + spout)
    is_shock = pstar - po > 0.0
    spin = torch.where(is_shock, ushock, spin)
    spout = torch.where(is_shock, ushock, spout)
    cavg = 0.5 * (c + c_m)
    scr = torch.where(spout - spin == 0.0, SMALL * cavg, spout - spin)
    frac = torch.clamp(0.5 * (1.0 + (spout + spin) / scr), 0.0, 1.0)

    def pick(star, o):
        v = frac * star + (1.0 - frac) * o
        v = torch.where(spout < 0.0, o, v)
        return torch.where(spin >= 0.0, star, v)

    return dict(rho=pick(rstar, ro), un=pick(ustar, uo), ut=ut, utt=utt,
                p_g=pick(pstar_g, po_g), rhoe_g=pick(estar_g, reo_g),
                ptot=torch.clamp(pick(pstar, po), min=small_pres),
                er=[torch.clamp(pick(estar_r[g], reo_r[g]), min=0.0) for g in range(ng)],
                lam=lam_int, ustar=ustar)


def rad_flux_and_qe(gd, qm, qp, d, layout, coord, limiter, closure, fspace_type=1):
    """The gas conserved flux, the radiation advective flux [ngroups] and
    the Godunov state [NGDNV] (reference compute_flux_q RADIATION
    branch)."""
    L = layout
    ng = L.ngroups
    un = gd["un"]
    frho = gd["rho"] * un
    zero = torch.zeros_like(frho)

    comps = [None] * L.NVAR
    comps[L.URHO] = frho
    im1 = L.momentum_index(d)
    im2, im3 = {0: (L.UMY, L.UMZ), 1: (L.UMX, L.UMZ), 2: (L.UMX, L.UMY)}[d]
    fm1 = frho * un
    if mom_flux_has_p(d, coord):
        fm1 = fm1 + gd["p_g"]
    comps[im1] = fm1
    comps[im2] = frho * gd["ut"]
    comps[im3] = frho * gd["utt"]
    rhoetot = gd["rhoe_g"] + 0.5 * gd["rho"] * (un * un + gd["ut"] ** 2 + gd["utt"] ** 2)
    comps[L.UEDEN] = un * (rhoetot + gd["p_g"])
    comps[L.UEINT] = un * gd["rhoe_g"]
    sgnm = torch.sign(un)
    fp = 0.5 * (1.0 + sgnm)
    fm = 0.5 * (1.0 - sgnm)
    for k in range(L.nspec + L.naux):
        comps[L.UFS + k] = frho * (fp * qm[L.QFS + k] + fm * qp[L.QFS + k])
    flux = torch.stack([zero if c is None else c for c in comps])

    # the radiation advective flux (fspace_type 1: (1 + f1) Er u)
    rf = []
    for g in range(ng):
        if fspace_type == 1:
            f1 = 0.5 * (1.0 - edd_factor(gd["lam"][g], limiter, closure))
            rf.append((1.0 + f1) * gd["er"][g] * un)
        else:
            rf.append(gd["er"][g] * un)
    rad_flux = torch.stack(rf)

    gcomps = [None] * L.NGDNV
    gcomps[L.GDRHO] = gd["rho"]
    gd_comp = {0: (L.GDU, L.GDV, L.GDW), 1: (L.GDV, L.GDU, L.GDW),
               2: (L.GDW, L.GDU, L.GDV)}[d]
    gcomps[gd_comp[0]] = un
    gcomps[gd_comp[1]] = gd["ut"]
    gcomps[gd_comp[2]] = gd["utt"]
    gcomps[L.GDPRES] = gd["p_g"]
    gcomps[L.GDGAME] = gd["p_g"] / torch.clamp(gd["rhoe_g"], min=torch.finfo(un.dtype).tiny) + 1.0
    for g in range(ng):
        gcomps[L.GDLAMS + g] = gd["lam"][g]
        gcomps[L.GDERADS + g] = gd["er"][g]
    return flux, rad_flux, torch.stack([zero if c is None else c for c in gcomps])


def rad_flatten(q, layout, flatten_pp_threshold=-1.0):
    """Radiation flattening: the product of the gas-pressure and
    total-pressure flattening, zeroed in converging flow under the
    pp-threshold (Castro_ctu_hydro.cpp:234-258)."""
    from castro_tpu_torch.ops.flatten import uflatten

    L = layout
    flatn = uflatten(q, L) * uflatten(q, L, pres_comp=L.QPTOT)
    if flatten_pp_threshold > 0.0:
        conv = 0.0
        for d in range(L.dim):
            vel = q[L.velocity_index(d)]
            conv = conv + shifted(vel, -1, d) - shifted(vel, 1, d)
        zero = (conv > 0.0) & (q[L.QPRES] < flatten_pp_threshold * q[L.QPTOT])
        flatn = torch.where(zero, torch.zeros_like(flatn), flatn)
    return flatn


def apply_av_rad(rflux, d, div_node, er_grown, layout, difmag, dx):
    """Artificial viscosity on each group's radiation flux (reference
    `apply_av_rad`, advection_util.cpp:533-573)."""
    L = layout
    div1 = div_node
    for od in range(L.dim):
        if od != d:
            div1 = 0.5 * (div1 + shifted(div1, 1, od))
    coeff = difmag * torch.clamp(div1, max=0.0) * dx[d]
    return rflux + coeff[None] * (er_grown - shifted(er_grown, -1, d + 1))


def ctu_rad_consup(u_new, Er, rfluxes, qes, dt, geom, layout, ng, limiter, closure,
                   fspace_type, comoving, nugroup=None, dlognu=None):
    """The radiation conservative update (`Castro::ctu_rad_consup`,
    Castro_ctu_rad.cpp:13-340): each group's Er flux divergence, the
    sum-lambda-grad-Er radiation pressure gradient on every momentum with
    its kinetic energy on UEDEN, and in the comoving frame the
    -(f1 div u + f2 nn:grad u) Er work terms with the fspace type-1
    u.grad(f1 Er) transport, then frequency-space advection of a multigroup
    spectrum.

    `u_new` is the grown hydro-updated state (its interior updated in the
    returned copy); `Er` the interior [ngroups, n...]; `rfluxes`/`qes` the
    grown face-registered arrays per direction. Returns (u_new, Er_out)."""
    L = layout
    dim = L.dim
    ngr = L.ngroups
    dx = geom.dx
    grid_shape = tuple(u_new.shape[1:])
    sl = interior_slice(ng, dim)[1:]
    allg = (slice(None),)

    # the Er flux divergence, with area/volume formed first (float32 range)
    volg = geom.volume(ng).expand(grid_shape)
    Er_out = Er
    for d in range(dim):
        area = geom.face_area(d, ng)
        rf = rfluxes[d]
        aF_lo = (area.expand(grid_shape) / volg)[None] * rf
        if geom.coord != CoordSys.CARTESIAN and d == 0:
            aF_hi = (shifted(area, 1, d).expand(grid_shape) / volg)[None] * shifted(rf, 1, 1 + d)
        else:
            aF_hi = shifted(aF_lo, 1, 1 + d)
        Er_out = Er_out + dt * (aF_lo[allg + sl] - aF_hi[allg + sl])

    def faces(arr, d):
        return arr[sl], shifted(arr, 1, arr.dim() - dim + d)[sl]

    lam_f = [[faces(qes[d][L.GDLAMS + g], d) for d in range(dim)] for g in range(ngr)]
    er_f = [[faces(qes[d][L.GDERADS + g], d) for d in range(dim)] for g in range(ngr)]
    lamc = [sum(lo + hi for lo, hi in lam_f[g]) / (2.0 * dim) for g in range(ngr)]

    # the radiation pressure gradient on the momenta
    dprd = []
    for d in range(dim):
        acc = 0.0
        for g in range(ngr):
            lo, hi = er_f[g][d]
            acc = acc + lamc[g] * (hi - lo) / dx[d]
        dprd.append(acc)

    u_new = u_new.clone()
    urho = u_new[(L.URHO,) + sl]
    moms = [u_new[(L.momentum_index(c),) + sl] for c in range(3)]
    ek1 = (moms[0] ** 2 + moms[1] ** 2 + moms[2] ** 2) / (2.0 * urho)
    for d in range(dim):
        moms[d] = moms[d] - dt * dprd[d]
        u_new[(L.momentum_index(d),) + sl] = moms[d]
    ek2 = (moms[0] ** 2 + moms[1] ** 2 + moms[2] ** 2) / (2.0 * urho)
    dek = ek2 - ek1
    u_new[(L.UEDEN,) + sl] = u_new[(L.UEDEN,) + sl] + dek

    if not comoving:
        # mixed frame (one group): the lab-frame Er takes the kinetic-energy
        # exchange (Castro_ctu_rad.cpp:162-166)
        Er_out = Er_out.clone()
        Er_out[0] = Er_out[0] - dek
        return u_new, torch.clamp(Er_out, min=0.0)

    # the comoving-frame work terms (Castro_ctu_rad.cpp:171-325)
    ubar = []
    dud = [[0.0] * 3 for _ in range(dim)]  # dud[j][c] = d(u_c)/dx_j
    for j in range(dim):
        for c in range(3):
            lo, hi = faces(qes[j][L.GDU + c], j)
            if c == j:
                ubar.append(0.5 * (lo + hi))
            dud[j][c] = (hi - lo) / dx[j]
    divu = sum(dud[j][j] for j in range(dim))

    af = []
    Er_out = Er_out.clone()
    for g in range(ngr):
        nhat = [(er_f[g][c][1] - er_f[g][c][0]) / dx[c] for c in range(dim)]
        # n.(grad u).n is scale-invariant in nhat: normalize before squaring
        # (cgs Er ~ 1e-15 would underflow float32 to 0/0)
        tiny = torch.finfo(nhat[0].dtype).tiny
        nscale = nhat[0] * 0.0
        for h in nhat:
            nscale = torch.maximum(nscale, torch.abs(h))
        nunit = [h / torch.clamp(nscale, min=tiny) for h in nhat]
        GnDotu = [sum(nunit[c] * dud[j][c] for c in range(dim)) for j in range(dim)]
        nn = sum(nunit[j] * GnDotu[j] for j in range(dim)) / (sum(h * h for h in nunit) + tiny)
        eddf = edd_factor(lamc[g], limiter, closure)
        f1 = 0.5 * (1.0 - eddf)
        f2 = 0.5 * (3.0 * eddf - 1.0)
        af.append(-(f1 * divu + f2 * nn))

        if fspace_type == 1:
            adv = 0.0
            for d in range(dim):
                lam_lo, lam_hi = lam_f[g][d]
                f1_lo = 0.5 * (1.0 - edd_factor(lam_lo, limiter, closure))
                f1_hi = 0.5 * (1.0 - edd_factor(lam_hi, limiter, closure))
                er_lo, er_hi = er_f[g][d]
                adv = adv + ubar[d] * ((f1_hi * er_hi - f1_lo * er_lo) / dx[d])
            Egdc = sum(lo + hi for lo, hi in er_f[g]) / (2.0 * dim)
            Er_out[g] = Er_out[g] + (dt * adv - dt * f2 * Egdc * nn)

    if ngr > 1 and dlognu is not None:
        from castro_tpu_torch.radiation.fspace import advect_in_fspace

        Er_out, _ = advect_in_fspace(Er_out, torch.stack(af), nugroup, dlognu, dt, fspace_type)
    return u_new, torch.clamp(Er_out, min=0.0)


def ctu_rad_hydro(u, Er, q, qaux, srcQ, dt, geom, layout, cfg, limiter, closure, nugroup=None,
                  dlognu=None, fspace_type=1, comoving=1, flatten_pp_threshold=-1.0,
                  keep_fluxes=False):
    """The CTU radiation-hydro advance of any dimension: characteristic
    tracing with the radiation eigensystem in every direction, the rad
    Riemann solve, the radiation-aware transverse corrections (2D one pass,
    3D full corner coupling; the RADIATION branches of trans.cpp), the gas
    conservative update, and the ctu_rad_consup radiation terms (the stage
    structure of Castro_ctu_hydro.cpp with RADIATION defined).

    Returns (u_new grown, Er_new interior [ngroups, n...]); `keep_fluxes`
    also returns the final gas and radiation-advective face fluxes on the
    grown grid for the AMR flux registers."""
    from castro_tpu_torch.ops import advection_util as au
    from castro_tpu_torch.ops import kernels as K
    from castro_tpu_torch.ops.ctu import _dloga
    from castro_tpu_torch.ops.trans import trans_final, trans_single

    L = layout
    dim = L.dim
    ng = cfg.ng
    dx = geom.dx
    dt = K.wt(dt, q.dtype)
    grid_shape = tuple(q.shape[1:])

    flatn = rad_flatten(q, L, flatten_pp_threshold) if cfg.use_flattening \
        else torch.ones(grid_shape, dtype=q.dtype, device=q.device)
    rad = dict(limiter=limiter, closure=closure, fspace_t=fspace_type, comov=comoving)
    dloga = _dloga(geom, ng)
    reset = (cfg.transverse_reset_density, cfg.transverse_reset_rhoe)

    def trace(d):
        return trace_ppm_rad(q, qaux, srcQ, flatn, d, dt, dx[d], L, cfg.small_dens,
                             cfg.small_pres, dloga=dloga if d == 0 else None)

    def solve(qm, qp, d):
        gd = riemannus_rad(qm, qp, qaux, d, L, cfg.small_dens, cfg.small_pres)
        return rad_flux_and_qe(gd, qm, qp, d, L, geom.coord, limiter, closure, fspace_type)

    states = [trace(d) for d in range(dim)]
    if dim == 1:
        sol = [solve(states[0][0], states[0][1], 0)]
    elif dim == 2:
        f0 = solve(states[0][0], states[0][1], 0)
        f1 = solve(states[1][0], states[1][1], 1)
        hdt = 0.5 * dt
        rz = geom.coord == CoordSys.CYLINDRICAL
        geom_r = geom_z = None
        if rz:
            geom_r = {"area": geom.face_area(0, ng), "vol": geom.volume(ng)}
            geom_z = {"area": geom.face_area(1, ng), "vol": geom.volume(ng)}
        qxm, qxp = trans_single(states[0][0], states[0][1], f1[0], f1[2], qaux, 0, 1,
                                hdt / dx[1], L, cfg.small_pres, *reset, geom_terms=geom_z,
                                hdt=hdt, rflux_t=f1[1], rad=rad)
        qym, qyp = trans_single(states[1][0], states[1][1], f0[0], f0[2], qaux, 1, 0,
                                hdt / dx[0], L, cfg.small_pres, *reset, geom_terms=geom_r,
                                hdt=hdt, radial_p_fix=rz and not mom_flux_has_p(0, geom.coord),
                                rflux_t=f0[1], rad=rad)
        sol = [solve(qxm, qxp, 0), solve(qym, qyp, 1)]
    else:
        third = dt / 3.0
        hdt = 0.5 * dt
        f1d = [solve(states[d][0], states[d][1], d) for d in range(3)]
        fint = {}
        for n in range(3):
            for t in range(3):
                if t == n:
                    continue
                qm_c, qp_c = trans_single(states[n][0], states[n][1], f1d[t][0], f1d[t][2],
                                          qaux, n, t, third / dx[t], L, cfg.small_pres,
                                          *reset, rflux_t=f1d[t][1], rad=rad)
                fint[(n, t)] = solve(qm_c, qp_c, n)
        del f1d
        sol = []
        for n in range(3):
            t1, t2 = [d for d in range(3) if d != n]
            qm_f, qp_f = trans_final(
                states[n][0], states[n][1], fint[(t1, t2)][0], fint[(t1, t2)][2],
                fint[(t2, t1)][0], fint[(t2, t1)][2], qaux, n, t1, t2,
                hdt / dx[t1], hdt / dx[t2], L, cfg.small_pres, *reset,
                rflux_t1=fint[(t1, t2)][1], rflux_t2=fint[(t2, t1)][1], rad=rad)
            sol.append(solve(qm_f, qp_f, n))
        del fint
    del states
    fluxes = [s[0] for s in sol]
    rfluxes = [s[1] for s in sol]
    qes = [s[2] for s in sol]
    del sol

    # artificial viscosity (gas + radiation) and species normalization
    div_node = au.divu_node(q, dx, L)
    er_grown = q[L.QRAD:L.QRAD + L.ngroups]
    for d in range(dim):
        fluxes[d] = au.apply_av(fluxes[d], d, div_node, u, L, cfg.difmag, dx)
        rfluxes[d] = apply_av_rad(rfluxes[d], d, div_node, er_grown, L, cfg.difmag, dx)
        fluxes[d] = au.normalize_species_fluxes(fluxes[d], L)

    # the gas conservative update (consup_hydro)
    volinv = 1.0 / geom.volume(ng)
    hsrc = torch.zeros_like(u)
    pdivu = torch.zeros(grid_shape, dtype=q.dtype, device=q.device)
    for d in range(dim):
        area = geom.face_area(d, ng)
        # area/volume first: area*flux overflows float32 in cgs 3D
        av_lo_r = area * volinv
        av_hi_r = shifted(area, 1, d) * volinv \
            if (geom.coord != CoordSys.CARTESIAN and d == 0) else av_lo_r
        hsrc = hsrc + (av_lo_r * fluxes[d] - av_hi_r * shifted(fluxes[d], 1, 1 + d))
        gdu = qes[d][(L.GDU, L.GDV, L.GDW)[d]]
        gdp = qes[d][L.GDPRES]
        pdivu = pdivu + 0.5 * (shifted(gdp, 1, d) + gdp) * (shifted(gdu, 1, d) * av_hi_r
                                                            - gdu * av_lo_r)
    hsrc[L.UEINT] = hsrc[L.UEINT] - pdivu
    hsrc[L.UTEMP] = 0.0
    if not mom_flux_has_p(0, geom.coord):
        gdp0 = qes[0][L.GDPRES]
        hsrc[L.UMX] = hsrc[L.UMX] + (-(shifted(gdp0, 1, 0) - gdp0) / dx[0])
    u_new = u + dt * hsrc
    del hsrc, pdivu

    out = ctu_rad_consup(u_new, Er, rfluxes, qes, dt, geom, L, ng, limiter, closure,
                         fspace_type, comoving, nugroup=nugroup, dlognu=dlognu)
    if keep_fluxes:
        return out + (fluxes, rfluxes)
    return out


def ctu_rad_hydro_1d(u, Er, q, qaux, srcQ, dt, geom, layout, cfg, limiter, closure,
                     nugroup=None, dlognu=None, fspace_type=1, comoving=1):
    """The 1D entry of the JAX package's older interface: the
    dimension-generic advance, (u_new, Er_new interior)."""
    return ctu_rad_hydro(u, Er, q, qaux, srcQ, dt, geom, layout, cfg, limiter, closure,
                         nugroup=nugroup, dlognu=dlognu, fspace_type=fspace_type,
                         comoving=comoving)
