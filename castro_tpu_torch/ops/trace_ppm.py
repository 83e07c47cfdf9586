"""Characteristic tracing of PPM parabolae to zone edges.

Counterpart of `castro_tpu/ops/trace_ppm.py` (reference
`Source/hydro/trace_ppm.cpp:16-596`), with the `dloga` geometry source of
1D/2D curvilinear runs (`geometry_source`).

Face convention: face index i == interface i-1/2. `qm[i]` (minus/left
state) comes from cell i-1 tracing to its right edge; `qp[i]` (plus/right
state) from cell i tracing to its left edge.
"""

from __future__ import annotations

import torch

from castro_tpu_torch.ops.ppm import (ppm_int_profile, ppm_int_profile_single,
                                      ppm_reconstruct)
from castro_tpu_torch.ops.stencil import shifted


def _vel_map(layout, d):
    if d == 0:
        return layout.QU, layout.QV, layout.QW
    if d == 1:
        return layout.QV, layout.QW, layout.QU
    return layout.QW, layout.QU, layout.QV


def wave_weight(speed, is_plus):
    """Wave-side weight: a stationary wave (sign 0) gets half weight on
    each side, which keeps at-rest data mirror-symmetric."""
    w_minus = 0.5 * (1.0 - torch.sign(speed))  # weight seen by qp
    return w_minus if is_plus else (1.0 - w_minus)


def geometry_source(q, qaux, un, dloga, dt, dtdx, layout):
    """The 1D/2D curvilinear geometry source of the x-states (reference
    trace_ppm.cpp:573-596): (sourcr, sourcp, source) added to the traced
    rho, p and rho e. `dloga` is d(ln A)/dr, 0 where the metric is flat."""
    L = layout
    rho_c = q[L.QRHO]
    cc = qaux[L.QC]
    csq = cc * cc
    courn = dtdx * (cc + torch.abs(un))
    safe_dloga = torch.where(dloga == 0.0, torch.ones_like(dloga), dloga)
    eta = (1.0 - courn) / (cc * dt * torch.abs(safe_dloga))
    dlogatmp = torch.where(dloga == 0.0, torch.zeros_like(eta),
                           torch.clamp(eta, max=1.0) * dloga)
    sourcr = -0.5 * dt * rho_c * dlogatmp * un
    sourcp = sourcr * csq
    source = sourcp * ((q[L.QPRES] + q[L.QREINT]) / rho_c) / csq
    return sourcr, sourcp, source


def trace_ppm(q, qaux, srcQ, flatn, d, dt, dx_d, layout, small_dens, small_pres,
              small_ener=1e-200, dloga=None):
    """Returns (qm_face, qp_face), both [NQ, grid] on faces i-1/2 stored at i.
    `dloga` (curvilinear 1D/2D) adds the geometry source to the x-states."""
    L = layout
    ax = d
    QUN, QUT, QUTT = _vel_map(L, d)

    un = q[QUN]
    cc = qaux[L.QC]
    dtdx = dt / dx_d
    hdt = 0.5 * dt

    def ppm3(s):
        sm, sp = ppm_reconstruct(s, flatn, ax)
        return ppm_int_profile(sm, sp, s, un, cc, dtdx)

    def ppm1(s):
        sm, sp = ppm_reconstruct(s, flatn, ax)
        return ppm_int_profile_single(sm, sp, s, un, dtdx)

    Ip_rho, Im_rho = ppm3(q[L.QRHO])
    Ip_un, Im_un = ppm3(un)
    Ip_p, Im_p = ppm3(q[L.QPRES])
    Ip_re, Im_re = ppm3(q[L.QREINT])
    Ip_gc, Im_gc = ppm3(qaux[L.QGAMC])
    Ip_ut, Im_ut = ppm1(q[QUT])
    Ip_utt, Im_utt = ppm1(q[QUTT])

    if srcQ is not None:
        Ip_srho, Im_srho = ppm3(srcQ[L.QRHO])
        Ip_sun, Im_sun = ppm3(srcQ[QUN])
        Ip_sp, Im_sp = ppm3(srcQ[L.QPRES])
        Ip_sre, Im_sre = ppm3(srcQ[L.QREINT])
        Ip_sut, Im_sut = ppm1(srcQ[QUT])
        Ip_sutt, Im_sutt = ppm1(srcQ[QUTT])
    else:
        z = torch.zeros_like(un)
        Ip_srho = Im_srho = Ip_sun = Im_sun = Ip_sp = Im_sp = Ip_sre = Im_sre = (z, z, z)
        Ip_sut = Im_sut = Ip_sutt = Im_sutt = z

    def build_state(I_rho, I_un, I_p, I_re, I_gc, I_ut, I_utt,
                    I_srho, I_sun, I_sp, I_sre, I_sut, I_sutt, is_plus):
        """is_plus: plus state (left edge, ref wave u-c, index 0);
        else minus state (right edge, ref wave u+c, index 2)."""
        r = 0 if is_plus else 2
        rho_ref = torch.clamp(I_rho[r] + hdt * I_srho[r], min=small_dens)
        un_ref = I_un[r] + hdt * I_sun[r]
        p_ref = torch.clamp(I_p[r] + hdt * I_sp[r], min=small_pres)
        rhoe_ref = I_re[r] + hdt * I_sre[r]
        gam_ref = I_gc[r]

        rho_ref_inv = 1.0 / rho_ref
        csq_ref = gam_ref * p_ref * rho_ref_inv
        cc_ref = torch.sqrt(csq_ref)
        cc_ref_inv = 1.0 / cc_ref
        h_ref = (p_ref + rhoe_ref) * rho_ref_inv

        dum = un_ref - I_un[0] - hdt * I_sun[0]
        dptotm = p_ref - I_p[0] - hdt * I_sp[0]
        drho = rho_ref - I_rho[1] - hdt * I_srho[1]
        dptot = p_ref - I_p[1] - hdt * I_sp[1]
        drhoe = rhoe_ref - I_re[1] - hdt * I_sre[1]
        dup = un_ref - I_un[2] - hdt * I_sun[2]
        dptotp = p_ref - I_p[2] - hdt * I_sp[2]

        alpham = 0.5 * (dptotm * rho_ref_inv * cc_ref_inv - dum) * rho_ref * cc_ref_inv
        alphap = 0.5 * (dptotp * rho_ref_inv * cc_ref_inv + dup) * rho_ref * cc_ref_inv
        alpha0r = drho - dptot / csq_ref
        alpha0e = drhoe - dptot * h_ref / csq_ref

        alpham = -alpham * wave_weight(un - cc, is_plus)
        alphap = -alphap * wave_weight(un + cc, is_plus)
        w0 = wave_weight(un, is_plus)
        alpha0r = -alpha0r * w0
        alpha0e = -alpha0e * w0

        out_rho = torch.clamp(rho_ref + alphap + alpham + alpha0r, min=small_dens)
        out_un = un_ref + (alphap - alpham) * cc_ref * rho_ref_inv
        out_re = torch.clamp(rhoe_ref + (alphap + alpham) * h_ref + alpha0e,
                             min=small_dens * small_ener)
        out_p = torch.clamp(p_ref + (alphap + alpham) * csq_ref, min=small_pres)
        out_ut = I_ut + hdt * I_sut
        out_utt = I_utt + hdt * I_sutt
        return out_rho, out_un, out_p, out_re, out_ut, out_utt

    qp_vals = build_state(Im_rho, Im_un, Im_p, Im_re, Im_gc, Im_ut, Im_utt,
                          Im_srho, Im_sun, Im_sp, Im_sre, Im_sut, Im_sutt, True)
    qm_vals = build_state(Ip_rho, Ip_un, Ip_p, Ip_re, Ip_gc, Ip_ut, Ip_utt,
                          Ip_srho, Ip_sun, Ip_sp, Ip_sre, Ip_sut, Ip_sutt, False)

    if dloga is not None and d == 0:
        sourcr, sourcp, source = geometry_source(q, qaux, un, dloga, dt, dtdx, L)
        fixed = []
        for rho_v, un_v, p_v, re_v, ut_v, utt_v in (qp_vals, qm_vals):
            fixed.append((torch.clamp(rho_v + sourcr, min=small_dens), un_v, p_v + sourcp,
                          re_v + source, ut_v, utt_v))
        qp_vals, qm_vals = fixed

    # full NQ interface states (QTEMP/QGAME copied through), cell-registered
    qp_comps = [q[i] for i in range(L.NQ)]
    qm_comps = [q[i] for i in range(L.NQ)]
    for comps, vals in ((qp_comps, qp_vals), (qm_comps, qm_vals)):
        rho_v, un_v, p_v, re_v, ut_v, utt_v = vals
        comps[L.QRHO] = rho_v
        comps[QUN] = un_v
        comps[QUT] = ut_v
        comps[QUTT] = utt_v
        comps[L.QPRES] = p_v
        comps[L.QREINT] = re_v

    # passives (species + aux): carried by the contact only
    for comp in range(L.QFS, L.QFS + L.nspec + L.naux):
        Ipp, Imp = ppm1(q[comp])
        qp_comps[comp] = Imp
        qm_comps[comp] = Ipp

    # register on faces: qm at face i comes from cell i-1's right-edge state
    qm_face = shifted(torch.stack(qm_comps), -1, 1 + ax)
    return qm_face, torch.stack(qp_comps)
