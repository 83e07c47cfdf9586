"""CTU transverse corrections (corner coupling), 2D and 3D.

Counterpart of `castro_tpu/ops/trans.py` (reference `Source/hydro/trans.cpp`):
- `trans_single` (:15/:67): add one transverse flux difference to the
  normal-direction interface states (the 2D pass, cdtdx = dt/(2dx), and
  the six corner-coupling passes of 3D CTU, cdtdx = dt/(3dx));
- `trans_final` (:442): add two corner-coupled transverse flux differences
  (the 3D final pass, cdtdx = dt/(2dx)).
With `use_kernels` each state's bundle is summed by `term_bundle` (torch
ops) and applied by `kernels.trans_apply`, as the JAX package does with
`trans_apply_pallas` (`castro_tpu/ops/trans.py:316-328`, `:356-371`). The
2D RZ pass (area-weighted `geom_terms`, `radial_p_fix`) is torch ops, as
the JAX package leaves it to XLA (`:316-317`).

The prim interface state is converted to conserved form, the transverse
flux divergence subtracted, a p-evolution-equation update applied to the
pressure, with the reference's reset ladder; `use_eos`
(transverse_use_eos) then recomputes (p, rho e) from the EOS. With `rad`
the RADIATION branches of trans.cpp join in (the characteristic rad-CTU
step, `ops/rad_hydro.py`): the lambda-weighted radiation pressure on the
transverse momentum, the u.lambda grad Er work on the energy, the
comoving Er terms and each group's Er update with the QPTOT/QREITOT
reassembly; they are torch ops, as the JAX package's are XLA.

Face convention: face arrays registered at i = interface i-1/2. For the
plus state (from cell i) cell_shift=0; for the minus state (from cell i-1)
cell_shift=-1.
"""

from __future__ import annotations

import torch

from castro_tpu_torch.ops.stencil import shifted


def _register(arr, ndim, n_ax, cell_shift, t_ax=None, t_off=0):
    """Register an array on an `ndim`-D grid at the state's cell: shift
    along the transverse axis by t_off, then along the normal axis by
    cell_shift. Leading component axes are allowed."""
    comp = arr.dim() - ndim
    out = arr
    if t_off:
        out = shifted(out, t_off, comp + t_ax)
    if cell_shift:
        out = shifted(out, cell_shift, comp + n_ax)
    return out


def _pass_ranges(layout):
    npass = layout.nspec + layout.naux
    return (list(range(layout.QFS, layout.QFS + npass)),
            list(range(layout.UFS, layout.UFS + npass)))


def _trans_apply(q_face, cell_shift, n_ax, terms, qaux, layout, small_pres,
                 transverse_reset_density=True, transverse_reset_rhoe=False, use_eos=None,
                 rad=None):
    """Apply one or two transverse flux-difference corrections.

    terms: list of dicts {flux [NVAR], qe [NGDNV], t_dir, cdtdx}, the
    flux and Godunov state face-registered along t_dir; in 2D RZ also
    `area` (face-registered along t_dir), `vol` (cell-registered) and
    `hdt`, which weight the differences by area/volume in place of cdtdx,
    and `radial_p_fix` (subtract cdtdx (pgp - pgm) from the radial
    momentum, whose flux lacks the pressure; trans.cpp:303-306).
    `use_eos` (an EOS) recomputes (p, rho e) from (rho, e, X) afterwards
    (transverse_use_eos; reference reset_edge_state_thermo). `rad`, a dict
    {limiter, closure, fspace_t, comov}, adds the radiation terms
    (trans.cpp:192-268, 313-334, 419-436, 676-722), each term then carrying
    its face-registered radiation flux `rflux` [ngroups, grid]."""
    L = layout

    def C(arr, t_ax=None, t_off=0):
        return _register(arr, qaux.dim() - 1, n_ax, cell_shift, t_ax, t_off)

    rho = q_face[L.QRHO]
    u = q_face[L.QU]
    v = q_face[L.QV]
    w = q_face[L.QW]
    reint = q_face[L.QREINT]
    p = q_face[L.QPRES]

    rr = rho
    ru, rv, rw = rho * u, rho * v, rho * w
    ekin = 0.5 * rho * (u * u + v * v + w * w)
    re = reint + ekin

    drr = dru = drv = drw = dre_tot = dreint = dp = 0.0
    pass_q, pass_u = _pass_ranges(L)
    dpass = {qc: 0.0 for qc in pass_q}
    # with radiation the p-evolution equation takes the gas gamma_1
    # (trans.cpp:216-222)
    gamc = C(qaux[L.QGAMCG if rad is not None else L.QGAMC])
    ngr = L.ngroups if rad is not None else 0
    if rad is not None:
        from castro_tpu_torch.ops.rad_hydro import edd_factor

        lam_c = [C(qaux[L.QLAMS + g]) for g in range(ngr)]
        ern = [q_face[L.QRAD + g] for g in range(ngr)]
        dmom = [0.0, 0.0, 0.0]  # the lambda grad Er momentum, per direction
        dre_rad = 0.0
        dern = [0.0] * ngr

    for t in terms:
        F = t["flux"]
        qe = t["qe"]
        t_ax = t["t_dir"]
        cdtdx = t["cdtdx"]
        rz = t.get("area") is not None
        if rz:
            area_lo = C(t["area"], t_ax=t_ax)
            area_hi = C(t["area"], t_ax=t_ax, t_off=1)
            volinv = 1.0 / C(t["vol"])
            hdt = t["hdt"]

        def dflux(comp):
            flo = C(F[comp], t_ax=t_ax)
            fhi = C(F[comp], t_ax=t_ax, t_off=1)
            if rz:
                return hdt * (area_hi * fhi - area_lo * flo) * volinv
            return cdtdx * (fhi - flo)

        gdu_comp = (L.GDU, L.GDV, L.GDW)[t_ax]
        pgm = C(qe[L.GDPRES], t_ax=t_ax)
        pgp = C(qe[L.GDPRES], t_ax=t_ax, t_off=1)
        ugm = C(qe[gdu_comp], t_ax=t_ax)
        ugp = C(qe[gdu_comp], t_ax=t_ax, t_off=1)
        if rz:
            dup = area_hi * pgp * ugp - area_lo * pgm * ugm
            du = area_hi * ugp - area_lo * ugm
        else:
            dup = pgp * ugp - pgm * ugm
            du = ugp - ugm
        pav = 0.5 * (pgp + pgm)

        drr = drr + dflux(L.URHO)
        dru = dru + dflux(L.UMX)
        drv = drv + dflux(L.UMY)
        drw = drw + dflux(L.UMZ)
        dre_tot = dre_tot + dflux(L.UEDEN)
        if rz:
            dreint = dreint + dflux(L.UEINT) + hdt * pav * du * volinv
            dp = dp + hdt * (dup + pav * du * (gamc - 1.0)) * volinv
        else:
            dreint = dreint + dflux(L.UEINT) + cdtdx * pav * du
            dp = dp + cdtdx * (dup + pav * du * (gamc - 1.0))
        for qc, uc in zip(pass_q, pass_u):
            dpass[qc] = dpass[qc] + dflux(uc)
        if t.get("radial_p_fix", False):
            dru = dru + cdtdx * (pgp - pgm)
        if rad is not None:
            # the radiation terms, added to the conserved interface state;
            # the lambda grad Er momentum goes to the transverse direction's
            # momentum (the reference's 3D trans_single adds it to UMX
            # always; the JAX package normalizes that, and so does this)
            rF = t["rflux"]
            uav = 0.5 * (ugp + ugm)
            for g in range(ngr):
                ergm = C(qe[L.GDERADS + g], t_ax=t_ax)
                ergp = C(qe[L.GDERADS + g], t_ax=t_ax, t_off=1)
                lamge = lam_c[g] * (ergp - ergm)
                luge = uav * lamge
                if rz and t_ax == 0:
                    # RZ radial transverse: area-weighted (trans.cpp:315-321)
                    dmom[0] = dmom[0] - 0.5 * hdt * (area_hi + area_lo) * lamge * volinv
                else:
                    dmom[t_ax] = dmom[t_ax] - cdtdx * lamge
                dre_rad = dre_rad - cdtdx * luge
                f1 = 0.5 * (1.0 - edd_factor(lam_c[g], rad["limiter"], rad["closure"]))
                if rad["fspace_t"] == 1 and rad["comov"]:
                    der = cdtdx * uav * f1 * (ergp - ergm)
                elif rad["fspace_t"] == 2:
                    der = cdtdx * f1 * 0.5 * (ergp + ergm) * (ugm - ugp)
                else:  # mixed frame
                    der = cdtdx * luge
                rflo = C(rF[g], t_ax=t_ax)
                rfhi = C(rF[g], t_ax=t_ax, t_off=1)
                if rz:
                    dern[g] = dern[g] - hdt * (area_hi * rfhi - area_lo * rflo) * volinv + der
                else:
                    dern[g] = dern[g] - cdtdx * (rfhi - rflo) + der

    rrnew = rr - drr
    runew = ru - dru
    rvnew = rv - drv
    rwnew = rw - drw
    renew = re - dre_tot
    if rad is not None:
        runew = runew + dmom[0]
        rvnew = rvnew + dmom[1]
        rwnew = rwnew + dmom[2]
        renew = renew + dre_rad
        ernew = [ern[g] + dern[g] for g in range(ngr)]

    # negative-density reset (trans.cpp:355-372)
    bad = (rrnew < 0.0) if transverse_reset_density else torch.zeros_like(rr, dtype=torch.bool)
    rrnew = torch.where(bad, rr, rrnew)
    runew = torch.where(bad, ru, runew)
    rvnew = torch.where(bad, rv, rvnew)
    rwnew = torch.where(bad, rw, rwnew)
    renew = torch.where(bad, re, renew)

    out = q_face.clone()
    out[L.QRHO] = rrnew
    rhoinv = 1.0 / rrnew
    out[L.QU] = runew * rhoinv
    out[L.QV] = rvnew * rhoinv
    out[L.QW] = rwnew * rhoinv

    rhoeken = 0.5 * (runew ** 2 + rvnew ** 2 + rwnew ** 2) * rhoinv
    reint_new = renew - rhoeken
    if transverse_reset_rhoe:
        reint_new = torch.where(reint_new <= 0.0, reint - dreint, reint_new)
    # fall back to the untouched interface value if still non-positive
    reint_new = torch.where(reint_new <= 0.0, reint, reint_new)
    out[L.QREINT] = torch.where(bad, reint, reint_new)
    out[L.QPRES] = torch.where(bad, p, torch.clamp(p - dp, min=small_pres))

    for qc in pass_q:
        out[qc] = torch.where(bad, q_face[qc], (rr * q_face[qc] - dpass[qc]) / rrnew)

    if rad is not None:
        # each group's Er, and the total pressure and energy reassembled
        # (trans.cpp:419-436, 843-857)
        ptot = out[L.QPRES]
        reitot = out[L.QREINT]
        for g in range(ngr):
            er_g = torch.where(bad, ern[g], ernew[g])
            out[L.QRAD + g] = er_g
            ptot = ptot + lam_c[g] * er_g
            reitot = reitot + er_g
        out[L.QPTOT] = ptot
        out[L.QREITOT] = reitot

    if use_eos is not None:
        es = use_eos.re(rho=out[L.QRHO],
                        e=torch.clamp(out[L.QREINT] / out[L.QRHO], min=1e-300),
                        xn=out[L.QFS: L.QFS + L.nspec])
        out[L.QREINT] = out[L.QRHO] * es.e
        out[L.QPRES] = torch.clamp(es.p, min=small_pres)
    return out


def term_bundle(terms, qaux, n_ax, cell_shift, layout):
    """The summed transverse bundle registered at the target state's cell:
    dflux [NVAR] = sum_t cdtdx_t (F_t(hi) - F_t(lo)), dre = sum_t cdtdx_t
    pav_t du_t, dp = sum_t cdtdx_t (dup_t + pav_t du_t (gamc - 1))
    (`castro_tpu/ops/trans.py:_term_bundle`, Cartesian)."""
    L = layout

    def C(arr, t_ax=None, t_off=0):
        return _register(arr, qaux.dim() - 1, n_ax, cell_shift, t_ax, t_off)

    gamc = C(qaux[L.QGAMC])
    dflux = dre = dp = 0.0
    for t in terms:
        F, qe, t_ax, cdtdx = t["flux"], t["qe"], t["t_dir"], t["cdtdx"]
        gdu_comp = (L.GDU, L.GDV, L.GDW)[t_ax]
        dflux = dflux + cdtdx * (C(F, t_ax=t_ax, t_off=1) - C(F, t_ax=t_ax))
        pgm = C(qe[L.GDPRES], t_ax=t_ax)
        pgp = C(qe[L.GDPRES], t_ax=t_ax, t_off=1)
        ugm = C(qe[gdu_comp], t_ax=t_ax)
        ugp = C(qe[gdu_comp], t_ax=t_ax, t_off=1)
        dup = pgp * ugp - pgm * ugm
        du = ugp - ugm
        pav = 0.5 * (pgp + pgm)
        dre = dre + cdtdx * pav * du
        dp = dp + cdtdx * (dup + pav * du * (gamc - 1.0))
    return dflux, dre, dp


def trans_apply_bundle(q, df, dre_x, dp_b, layout, small_pres, reset_density,
                       reset_rhoe):
    """The conserved update + reset ladder of the reference
    actual_trans_single/final (trans.cpp:67,442) given a summed bundle
    (`castro_tpu/ops/pallas_kernels.py:_trans_apply_block`;
    `csrc/trans.cuh` per face)."""
    L = layout
    rho = q[L.QRHO]
    uu = q[L.QU]
    vv = q[L.QV]
    ww = q[L.QW]
    reint = q[L.QREINT]
    p = q[L.QPRES]

    rr = rho
    ru, rv, rw = rho * uu, rho * vv, rho * ww
    ekin = 0.5 * rho * (uu * uu + vv * vv + ww * ww)
    re = reint + ekin

    rrnew = rr - df[L.URHO]
    runew = ru - df[L.UMX]
    rvnew = rv - df[L.UMY]
    rwnew = rw - df[L.UMZ]
    renew = re - df[L.UEDEN]
    dreint = df[L.UEINT] + dre_x

    bad = (rrnew < 0.0) if reset_density else torch.zeros_like(rr, dtype=torch.bool)
    rrnew = torch.where(bad, rr, rrnew)
    runew = torch.where(bad, ru, runew)
    rvnew = torch.where(bad, rv, rvnew)
    rwnew = torch.where(bad, rw, rwnew)
    renew = torch.where(bad, re, renew)

    rhoinv = 1.0 / rrnew
    rhoeken = 0.5 * (runew ** 2 + rvnew ** 2 + rwnew ** 2) * rhoinv
    reint_new = renew - rhoeken
    if reset_rhoe:
        reint_new = torch.where(reint_new <= 0.0, reint - dreint, reint_new)
    reint_new = torch.where(reint_new <= 0.0, reint, reint_new)
    reint_new = torch.where(bad, reint, reint_new)
    pnew = torch.where(bad, p, torch.clamp(p - dp_b, min=small_pres))

    comps = [q[i] for i in range(L.NQ)]
    comps[L.QRHO] = rrnew
    comps[L.QU] = runew * rhoinv
    comps[L.QV] = rvnew * rhoinv
    comps[L.QW] = rwnew * rhoinv
    comps[L.QREINT] = reint_new
    comps[L.QPRES] = pnew
    pass_q, pass_u = _pass_ranges(L)
    for qc, uc in zip(pass_q, pass_u):
        comps[qc] = torch.where(bad, q[qc], (rr * q[qc] - df[uc]) / rrnew)
    return torch.stack(comps)


def _corrected_states(qm, qp, terms, qaux, n_dir, layout, small_pres, reset_density,
                      reset_rhoe, use_kernels, use_eos_p=None, use_eos_m=None, rad=None):
    """Both interface states of normal n_dir corrected by `terms`: the plus
    state registered at its own cell (shift 0), the minus state at the cell
    below (shift -1)."""
    if use_kernels:
        from castro_tpu_torch.ops import kernels as K

        out = []
        for q_face, cshift in ((qp, 0), (qm, -1)):
            df, dre, dp = term_bundle(terms, qaux, n_dir, cshift, layout)
            out.append(K.trans_apply(q_face, df, dre, dp, layout, small_pres,
                                     reset_density, reset_rhoe))
        return out[1], out[0]
    qpo = _trans_apply(qp, 0, n_dir, terms, qaux, layout, small_pres,
                       reset_density, reset_rhoe, use_eos=use_eos_p, rad=rad)
    qmo = _trans_apply(qm, -1, n_dir, terms, qaux, layout, small_pres,
                       reset_density, reset_rhoe, use_eos=use_eos_m, rad=rad)
    return qmo, qpo


def trans_single(qm, qp, flux_t, qe_t, qaux, n_dir, t_dir, cdtdx, layout,
                 small_pres, reset_density=True, reset_rhoe=False, geom_terms=None,
                 radial_p_fix=False, hdt=None, use_kernels=False, use_eos=None,
                 rflux_t=None, rad=None):
    """Single transverse correction of both interface states
    (reference `trans_single`, trans.cpp:15). `geom_terms` = {area, vol}
    and `hdt` weight the 2D RZ pass; it, `radial_p_fix` and the radiation
    terms (`rad`, with the t-direction radiation flux `rflux_t`) take the
    torch ops whatever `use_kernels` says, as the JAX package takes XLA."""
    term = {"flux": flux_t, "qe": qe_t, "t_dir": t_dir, "cdtdx": cdtdx, "rflux": rflux_t}
    if geom_terms:
        term.update(geom_terms, hdt=hdt)
    if radial_p_fix:
        term["radial_p_fix"] = True
    kern = use_kernels and not geom_terms and not radial_p_fix and rad is None
    return _corrected_states(qm, qp, [term], qaux, n_dir, layout, small_pres,
                             reset_density, reset_rhoe, kern, use_eos, use_eos, rad=rad)


def trans_final(qm, qp, flux_t1, qe_t1, flux_t2, qe_t2, qaux,
                n_dir, t1_dir, t2_dir, cdtdx_t1, cdtdx_t2, layout,
                small_pres, reset_density=True, reset_rhoe=False, use_kernels=False,
                use_eos=None, rflux_t1=None, rflux_t2=None, rad=None):
    """Double transverse correction (reference `trans_final`, trans.cpp:442).
    `use_eos` re-evaluates the plus state only, as the JAX package's XLA
    path does (`castro_tpu/ops/trans.py:378-381`); `rad` as in
    `trans_single`, with the radiation fluxes of both terms."""
    terms = [
        {"flux": flux_t1, "qe": qe_t1, "t_dir": t1_dir, "cdtdx": cdtdx_t1, "rflux": rflux_t1},
        {"flux": flux_t2, "qe": qe_t2, "t_dir": t2_dir, "cdtdx": cdtdx_t2, "rflux": rflux_t2},
    ]
    return _corrected_states(qm, qp, terms, qaux, n_dir, layout, small_pres,
                             reset_density, reset_rhoe, use_kernels and rad is None, use_eos,
                             None, rad=rad)
