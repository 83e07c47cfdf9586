"""Fourth-order finite-volume machinery (McCorquodale & Colella), the
counterpart of `castro_tpu/ops/fourth_order.py` (reference
`Source/hydro/fourth_order.cpp`, `fourth_center_average.cpp` and the
`sdc_order == 4` branch of `Castro_mol_hydro.cpp`).

All conversions use the dimensionless second difference
Delta_d a = a_{i+1} - 2 a_i + a_{i-1}; cell-average <-> cell-centre and
face-average <-> face-centre transforms differ at O(dx^2) by lap/24.
Cartesian only, as the reference's 4th-order path is.

`mol4_hydro` makes two Riemann solves a direction (the face-centre states
and the face-average states), through `riemann.cmpflx`: with
`cfg.use_kernels` and riemann_solver 0 or 2 that is the cmpflx kernel
(`ops/kernels.py:cmpflx`, its plain version on CPU tensors), else torch
ops.
"""

from __future__ import annotations

import torch

from castro_tpu_torch.geometry import CoordSys
from castro_tpu_torch.ops.stencil import shifted


def lap2(a, axis):
    """Second difference along axis (dimensionless Laplacian term)."""
    return shifted(a, 1, axis) - 2.0 * a + shifted(a, -1, axis)


def cell_avg_to_center(a, dim, comp_axes=1):
    """<a> -> a(centre): subtract lap/24 over all spatial axes
    (fourth_center_average.cpp compute_lap_term)."""
    out = a
    for d in range(dim):
        out = out - lap2(a, comp_axes + d) / 24.0
    return out


def cell_center_to_avg(a, dim, comp_axes=1):
    """a(centre) -> <a>: add lap/24 over all spatial axes."""
    out = a
    for d in range(dim):
        out = out + lap2(a, comp_axes + d) / 24.0
    return out


def fourth_interface(a, d, comp_axes=1):
    """Single-valued 4th-order interface average at face i-1/2 @ i:
    a_f = 7/12 (a_{i-1} + a_i) - 1/12 (a_{i-2} + a_{i+1})
    (fourth_order.cpp fourth_interfaces)."""
    ax = comp_axes + d
    return (7.0 / 12.0) * (shifted(a, -1, ax) + a) \
        - (1.0 / 12.0) * (shifted(a, -2, ax) + shifted(a, 1, ax))


def face_avg_to_center(f, d, dim, comp_axes=1):
    """<f>_face -> f(face centre): subtract the transverse lap/24."""
    out = f
    for t in range(dim):
        if t != d:
            out = out - lap2(f, comp_axes + t) / 24.0
    return out


def face_center_to_avg_correction(f, d, dim, comp_axes=1):
    """The +lap/24 transverse correction used on fluxes:
    <F> = F(centre) + 1/24 sum_t Delta_t F(<q>_face)."""
    out = torch.zeros_like(f)
    for t in range(dim):
        if t != d:
            out = out + lap2(f, comp_axes + t) / 24.0
    return out


def fourth_avisc(q, qaux, d, dim, dx, layout, beta=0.3):
    """Face-centred 4th-order artificial viscosity coefficient
    (McCorquodale-Colella Eq. 35-36; fourth_order.cpp:750-845): a face
    divergence with a quadratic switch that vanishes as O(divu^3) in
    smooth flow, so the formal order is kept."""
    L = layout
    vel = (L.QU, L.QV, L.QW)
    avis = (q[vel[d]] - shifted(q[vel[d]], -1, d)) / dx[d]
    for t in range(dim):
        if t == d:
            continue
        vt = q[vel[t]]
        term = (shifted(vt, 1, t) - shifted(vt, -1, t)
                + shifted(shifted(vt, 1, t), -1, d)
                - shifted(shifted(vt, -1, t), -1, d))
        avis = avis + 0.25 * term / dx[t]
    c = qaux[L.QC]
    cmin = torch.minimum(c, shifted(c, -1, d))
    coeff = torch.clamp((dx[d] * avis) ** 2 / (beta * cmin * cmin), max=1.0)
    return torch.where(avis < 0.0, dx[d] * avis * coeff, torch.zeros_like(avis))


def mol4_prims(u_avg, layout, cfg, eos, small_temp):
    """The primitives of cell averages: (q_cc, q_avg, qaux, flatn). u_cc =
    <U> - lap/24, the pointwise ctoprim to q_cc, <q> = q_cc + lap/24, and
    the flattening coefficient of q_cc (ones without use_flattening)."""
    from castro_tpu_torch.ops import advection_util as au
    from castro_tpu_torch.ops.flatten import uflatten

    L = layout
    lap_u = torch.zeros_like(u_avg)
    for d in range(L.dim):
        lap_u = lap_u + lap2(u_avg, 1 + d)
    u_cc = u_avg - lap_u / 24.0
    q_cc, qaux = au.ctoprim(u_cc, L, eos, cfg.small_dens, small_temp)
    flatn = uflatten(q_cc, L) if cfg.use_flattening else torch.ones_like(q_cc[L.QRHO])
    return q_cc, cell_center_to_avg(q_cc, L.dim), qaux, flatn


def mol4_face_states(q_cc, q_avg, flatn, d, layout):
    """The face-average states (qm_avg, qp_avg) on the faces normal to d,
    face i-1/2 at index i: the single-valued 4th-order interface average of
    <q>, blended toward the limited PLM states where the flattening
    coefficient drops below 1 (the JAX package's analog of
    limit_fourth_order=1). The face-centre states are their
    `face_avg_to_center`."""
    from castro_tpu_torch.ops.mol import _plm_interface_states

    qf_avg = fourth_interface(q_avg, d)
    qm2, qp2 = _plm_interface_states(q_cc, flatn, d, layout, 4)
    w = 0.5 * (flatn + shifted(flatn, -1, d))  # face-registered
    return w * qf_avg + (1.0 - w) * qm2, w * qf_avg + (1.0 - w) * qp2


def mol4_hydro(u_avg, geom, layout, cfg, eos, small_temp):
    """4th-order MOL advective operator A(U) = -div<F> on cell averages.

    Pipeline (Castro_mol_hydro.cpp sdc_order==4 + fourth_order.cpp):
      u_cc = <U> - lap/24           -> q_cc (pointwise ctoprim)
      <q>  = q_cc + lap(q_cc)/24
      per dir: <q>_f (fourth_interfaces), q_f,cc (transverse lap),
      F_cc = F(q_f,cc), <F> = F_cc + lap_t(F(<q>_f))/24,
      A = -(1/dx) d<F>.
    The face states are `mol4_face_states`. Returns (adv [NVAR, ...],
    fluxes, qes). Raises on a curvilinear grid, where the JAX package
    asserts."""
    from castro_tpu_torch.ops import advection_util as au
    from castro_tpu_torch.ops.riemann import cmpflx

    L = layout
    dim = L.dim
    if geom.coord != CoordSys.CARTESIAN:
        raise ValueError("4th-order MOL is Cartesian-only (matches the reference)")
    dx = geom.dx
    q_cc, q_avg, qaux, flatn = mol4_prims(u_avg, L, cfg, eos, small_temp)
    avisc_coeff = 0.3 * (cfg.difmag / 0.1)

    def solve(qm, qp, d):
        return cmpflx(qm, qp, qaux, d, L, geom.coord, riemann_solver=cfg.riemann_solver,
                      small_dens=cfg.small_dens, small_pres=cfg.small_pres,
                      use_kernels=cfg.use_kernels)

    skip = torch.ones((L.NVAR,) + (1,) * dim, dtype=u_avg.dtype, device=u_avg.device)
    skip[L.UTEMP] = 0.0
    if L.shock_var:
        skip[L.USHK] = 0.0
    fluxes = []
    qes = []
    adv = torch.zeros_like(u_avg)
    for d in range(dim):
        qm_avg, qp_avg = mol4_face_states(q_cc, q_avg, flatn, d, L)
        F_cc, qe = solve(face_avg_to_center(qm_avg, d, dim),
                         face_avg_to_center(qp_avg, d, dim), d)
        F_avg_states = solve(qm_avg, qp_avg, d)[0]
        del qm_avg, qp_avg
        F = F_cc + face_center_to_avg_correction(F_avg_states, d, dim)
        del F_cc, F_avg_states

        # 4th-order-preserving artificial viscosity (MC Eq. 35-36)
        avis = fourth_avisc(q_cc, qaux, d, dim, dx, L)
        du = u_avg - shifted(u_avg, -1, 1 + d)
        F = F + skip * (avisc_coeff * avis)[None] * du
        F = au.normalize_species_fluxes(F, L)
        fluxes.append(F)
        qes.append(qe)
        adv = adv + (F - shifted(F, 1, 1 + d)) / dx[d]

    adv[L.UTEMP] = 0.0
    if L.shock_var:
        adv[L.USHK] = 0.0
    return adv, fluxes, qes
