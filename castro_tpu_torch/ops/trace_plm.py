"""Piecewise-linear characteristic tracing (counterpart of
`castro_tpu/ops/trace_plm.py`; reference `trace_plm`,
`Source/hydro/trace_plm.cpp:1-339`): limited slopes projected onto the
{u-c, u, u+c} eigensystem, only the waves moving toward each edge traced,
with 0.5*dt source participation, the optional well-balanced pslope and
the 1D/2D curvilinear geometry source.

Face convention as trace_ppm: face i == interface i-1/2; qm[i] from cell
i-1's right edge, qp[i] from cell i's left edge."""

from __future__ import annotations

import torch

from castro_tpu_torch.ops.slope import pslope, uslope
from castro_tpu_torch.ops.stencil import shifted
from castro_tpu_torch.ops.trace_ppm import _vel_map, geometry_source


def trace_plm(q, qaux, srcQ, flatn, d, dt, dx_d, layout, small_dens, small_pres,
              plm_iorder=4, use_pslope=False, pslope_cutoff_density=-1e20, dloga=None):
    """Returns (qm_face, qp_face), both [NQ, grid]. plm_iorder (the
    reference's plm_limiter): 1 the 2nd-order MC limiter, 2 or 4 the
    4th-order one."""
    L = layout
    ax = d
    QUN, QUT, QUTT = _vel_map(L, d)

    rho = q[L.QRHO]
    un = q[QUN]
    p = q[L.QPRES]
    rhoe = q[L.QREINT]
    cc = qaux[L.QC]
    csq = cc * cc
    dtdx = dt / dx_d
    hdt = 0.5 * dt
    order = 4 if plm_iorder in (2, 4) else 2

    drho = uslope(rho, flatn, ax, order)
    dun = uslope(un, flatn, ax, order)
    dut = uslope(q[QUT], flatn, ax, order)
    dutt = uslope(q[QUTT], flatn, ax, order)
    drhoe = uslope(rhoe, flatn, ax, order)
    if use_pslope and srcQ is not None:
        dp = pslope(p, rho, srcQ[QUN], flatn, ax, dx_d, pslope_cutoff_density)
    else:
        dp = uslope(p, flatn, ax, order)

    # characteristic amplitudes alpha_k = l_k . dq
    alpham = 0.5 * (dp / (rho * cc) - dun) * rho / cc
    alphap = 0.5 * (dp / (rho * cc) + dun) * rho / cc
    alpha0r = drho - dp / csq
    alpha0e = drhoe - dp * (rhoe + p) / (rho * csq)
    lam_m, lam_0, lam_p = un - cc, un, un + cc

    def edge_states(sign):
        """sign=+1: the right-edge state (qm's cell); -1: the left edge
        (qp). Only waves moving toward the edge contribute, each with the
        (sign - dtdx lambda)/2 fraction of its slope."""
        def w(lam):
            moving = lam >= 0.0 if sign > 0 else lam <= 0.0
            return torch.where(moving, 0.5 * (sign - dtdx * lam), torch.zeros_like(lam))

        wm, w0, wp = w(lam_m), w(lam_0), w(lam_p)
        rho_e = rho + wm * alpham + w0 * alpha0r + wp * alphap
        un_e = un + (wp * alphap - wm * alpham) * cc / rho
        p_e = p + (wp * alphap + wm * alpham) * csq
        rhoe_e = rhoe + (wp * alphap + wm * alpham) * (rhoe + p) / rho + w0 * alpha0e
        ut_e = q[QUT] + w0 * dut
        utt_e = q[QUTT] + w0 * dutt
        if srcQ is not None:
            rho_e = rho_e + hdt * srcQ[L.QRHO]
            un_e = un_e + hdt * srcQ[QUN]
            p_e = p_e + hdt * srcQ[L.QPRES]
            rhoe_e = rhoe_e + hdt * srcQ[L.QREINT]
            ut_e = ut_e + hdt * srcQ[QUT]
            utt_e = utt_e + hdt * srcQ[QUTT]
        return [torch.clamp(rho_e, min=small_dens), un_e, torch.clamp(p_e, min=small_pres),
                rhoe_e, ut_e, utt_e]

    qm_vals = edge_states(+1)
    qp_vals = edge_states(-1)

    if dloga is not None and d == 0:
        sourcr, sourcp, source = geometry_source(q, qaux, un, dloga, dt, dtdx, L)
        for vals in (qm_vals, qp_vals):
            vals[0] = torch.clamp(vals[0] + sourcr, min=small_dens)
            vals[2] = vals[2] + sourcp
            vals[3] = vals[3] + source

    def assemble(vals):
        comps = [q[i] for i in range(L.NQ)]
        for comp, v in zip((L.QRHO, QUN, L.QPRES, L.QREINT, QUT, QUTT), vals):
            comps[comp] = v
        return comps

    qm_comps, qp_comps = assemble(qm_vals), assemble(qp_vals)
    # passives: upwind with the contact fraction
    zero = torch.zeros_like(lam_0)
    wm = torch.where(lam_0 >= 0.0, 0.5 * (1.0 - dtdx * lam_0), zero)
    wp = torch.where(lam_0 <= 0.0, 0.5 * (-1.0 - dtdx * lam_0), zero)
    for comp in range(L.QFS, L.QFS + L.nspec + L.naux):
        dX = uslope(q[comp], flatn, ax, order)
        qm_comps[comp] = q[comp] + wm * dX
        qp_comps[comp] = q[comp] + wp * dX

    qm_face = shifted(torch.stack(qm_comps), -1, 1 + ax)
    return qm_face, torch.stack(qp_comps)
