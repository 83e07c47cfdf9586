"""The CTU (corner transport upwind) unsplit Godunov hydro update in one, two
or three dimensions, Cartesian, 2D RZ and 1D cylindrical or spherical.

Counterpart of `castro_tpu/ops/ctu.py` (reference `construct_ctu_hydro_source`,
`Source/hydro/Castro_ctu_hydro.cpp:17-1528`): ctoprim -> flatten -> shock
detect -> PPM or PLM trace per dim -> 1D Riemann -> transverse corrections
(2D: one pass per direction; 3D: six corner-coupled stages and three final
stages) -> artificial viscosity, the positivity and speed flux limiters,
species flux normalization and the conservative update with p div(u) and
the curvilinear radial pressure gradient.

`cfg.use_kernels` chooses between two structures that compute the same
update. With it (CUDA kernels on the card, their plain versions on the CPU):
- 3D fused (`riemann_solver` 0 or 2, no `hybrid_riemann`; the JAX package's
  fused Pallas structure, `ctu.py:185-325`): the trace kernel emits the 1D
  fluxes (with PLM, `ppm_type=0`, the trace is torch ops and three
  `ctu_face` launches with terms=[] solve them), one `ctu_face` launch per
  normal pairs its two corner stages, and the final stage of each normal
  folds its consup pass, normal 2 emitting u + dt*hsrc. With a flux
  limiter the finals do not fold consup: the torch ops clean the fluxes and
  update (`ctu.py:281-284`, `:391-393`);
- 3D unfused (`riemann_solver=1` or `hybrid_riemann`; `ctu.py:326-358`,
  `:394-411`): flatten and trace kernels, the 12 Riemann solves as torch
  ops (riemanncg, or riemannus + the HLL hybrid), 18 `trans_apply` launches
  and one `consup` launch per direction;
- 2D: `cmpflx` for the two 1D solves and `trans_cmpflx` for the final stage
  of each direction (the JAX package launches `trans_apply_pallas` four
  times and `cmpflx_pallas` twice there; the arithmetic per face is the
  same), or with `riemann_solver=1` / `hybrid_riemann` four `trans_apply`
  launches around torch-op solves; 2D RZ: `cmpflx` for all four solves, the
  area-weighted transverse pass as torch ops (the JAX package's XLA path
  there); 1D: one `cmpflx`.
Without it, the plain structure (the JAX package's XLA path, `ctu.py:326-358`,
`:424-480`) of separate trace, Riemann, transverse and consup passes; the
driver takes it on the card with `transverse_use_eos`, as the JAX package
turns its kernel route off for that option.

With `use_shock_var` the shock flag is written into USHK (set, not
fluxed), and with `hybrid_hydro` the hybrid momenta take their own fluxes,
the radial pressure gradient and the linear-momentum sync
(`castro_tpu/ops/ctu.py:363-420`, `:472-477`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from castro_tpu_torch.geometry import CoordSys
from castro_tpu_torch.ops import advection_util as au
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops.fill import WALLS
from castro_tpu_torch.ops.flatten import uflatten
from castro_tpu_torch.ops.riemann import WallMask, cmpflx, mom_flux_has_p
from castro_tpu_torch.ops.stencil import shifted
from castro_tpu_torch.ops.trace_plm import trace_plm
from castro_tpu_torch.ops.trace_ppm import trace_ppm
from castro_tpu_torch.ops.trans import term_bundle, trans_final, trans_single


class HydroConfig(NamedTuple):
    """Static hydro knobs (subset of castro.* params used by the CTU chain)."""

    use_flattening: bool = True
    difmag: float = 0.1
    riemann_solver: int = 0
    small_dens: float = 1e-200
    small_pres: float = 1e-200
    small_ener: float = 1e-200
    transverse_reset_density: bool = True
    transverse_reset_rhoe: bool = False
    ppm_type: int = 1
    use_shock_var: bool = False
    shock_threshold: float = 2.0 / 3.0
    hybrid_riemann: bool = False
    #: evolve the hybrid momenta with their own fluxes (castro.hybrid_hydro)
    hybrid_hydro: bool = False
    use_pslope: bool = False
    plm_iorder: int = 2
    pslope_cutoff_density: float = -1.0e20
    limit_fluxes_on_small_dens: bool = False
    speed_limit: float = 0.0
    cfl: float = 0.8
    #: the kernel structure (CUDA kernels on the card, their plain versions
    #: on the CPU) instead of the plain structure
    use_kernels: bool = False
    lo_bc: Tuple[int, ...] = (0, 0, 0)
    hi_bc: Tuple[int, ...] = (0, 0, 0)
    ng: int = 4


def _bnd_masks(grid_shape, dim, ng, lo_bc, hi_bc):
    """Per-direction WallMask zeroing the interface velocity on symmetry
    and wall domain faces (reference bnd_fac, riemann.cpp:55-61), or None."""
    masks = []
    for d in range(dim):
        lo_wall = lo_bc[d] in WALLS
        hi_wall = hi_bc[d] in WALLS
        if not (lo_wall or hi_wall):
            masks.append(None)
            continue
        n = grid_shape[d]
        masks.append(WallMask(d, n, ng if lo_wall else -1, n - ng if hi_wall else -1))
    return masks


def _dloga(geom, ng):
    """d(ln A)/dr of the radial direction of a curvilinear grid (the dloga
    metric of the trace's geometry source), or None when Cartesian."""
    if geom.coord == CoordSys.CARTESIAN:
        return None
    r = geom.cell_centers(0, ng)
    return (1.0 if geom.coord == CoordSys.CYLINDRICAL else 2.0) / r


def ctu_hydro(u, q, qaux, srcQ, dt, geom, layout, cfg: HydroConfig,
              div_node=None, fold_update_dt=None, trans_eos=None):
    """The CTU hydro update of grown, ghost-filled arrays.

    Returns (hsrc [NVAR], or u + fold_update_dt*hsrc when given; the final
    fluxes per dim [NVAR, faces]; the Godunov states per dim [NGDNV,
    faces]; the shock flag, or None unless `hybrid_riemann`). The interior
    is valid; the ghost margin is garbage. `trans_eos` (an EOS, for
    transverse_use_eos) re-evaluates the transversely corrected states."""
    L = layout
    dim = L.dim
    dx = geom.dx
    coord = geom.coord
    grid_shape = tuple(q.shape[1:])
    dt = K.wt(dt, q.dtype)
    kern = cfg.use_kernels
    # riemann_solver 0 and 2 have a kernel; riemanncg and the HLL hybrid do not
    kernel_solve = kern and not cfg.hybrid_riemann and cfg.riemann_solver in (0, 2)
    limiters = bool(cfg.limit_fluxes_on_small_dens) or cfg.speed_limit > 0.0
    if cfg.use_flattening:
        flatn = K.flatten(q, L) if kern and dim == 3 else uflatten(q, L)
    else:
        flatn = torch.ones(grid_shape, dtype=q.dtype, device=q.device)
    need_shk = cfg.use_shock_var or cfg.hybrid_riemann
    shk = au.shock(q, dx, L, cfg.shock_threshold) if need_shk else None
    if div_node is None:
        div_node = au.divu_node(q, dx, L)
    dloga = _dloga(geom, cfg.ng)
    masks = _bnd_masks(grid_shape, dim, cfg.ng, cfg.lo_bc, cfg.hi_bc)

    def trace(d, with_kernel=False):
        if cfg.ppm_type == 0:
            return trace_plm(q, qaux, srcQ, flatn, d, dt, dx[d], L, cfg.small_dens,
                             cfg.small_pres, plm_iorder=cfg.plm_iorder,
                             use_pslope=cfg.use_pslope,
                             pslope_cutoff_density=cfg.pslope_cutoff_density, dloga=dloga)
        if with_kernel:
            return K.trace_ppm(q, qaux, srcQ, flatn, d, dt, dx[d], L, cfg.small_dens,
                               cfg.small_pres, cfg.small_ener)
        return trace_ppm(q, qaux, srcQ, flatn, d, dt, dx[d], L, cfg.small_dens,
                         cfg.small_pres, cfg.small_ener, dloga=dloga)

    if kernel_solve and dim == 3:
        hsrc, fluxes, qes = _ctu_kernels(u, q, qaux, srcQ, dt, dx, flatn, div_node, masks, L,
                                         cfg, fold_update_dt, trace, consup=not limiters)
        if not limiters:
            return _finish(hsrc, u, shk, dt, fold_update_dt, fluxes, qes, geom, L, cfg)
        return _update(u, q, fluxes, qes, None, dt, div_node, geom, L, cfg, fold_update_dt)

    def solve(qm, qp, d):
        return cmpflx(qm, qp, qaux, d, L, coord, riemann_solver=cfg.riemann_solver,
                      small_dens=cfg.small_dens, small_pres=cfg.small_pres,
                      bnd_mask=masks[d], hybrid_riemann=cfg.hybrid_riemann, shk=shk,
                      use_kernels=kern)

    reset = (cfg.transverse_reset_density, cfg.transverse_reset_rhoe)
    states = [trace(d, with_kernel=kern and dim == 3) for d in range(dim)]
    if dim == 1:
        fluxes_qe = [solve(states[0][0], states[0][1], 0)]
    elif dim == 2:
        f1d = [solve(states[d][0], states[d][1], d) for d in range(2)]
        hdt = 0.5 * dt
        rz = coord == CoordSys.CYLINDRICAL
        fluxes_qe = []
        for n, t in ((0, 1), (1, 0)):
            # correct the n-states with the t-fluxes, then solve (reference
            # 2D pass, Castro_ctu_hydro.cpp:575-696)
            if kernel_solve and not rz and trans_eos is None:
                fluxes_qe.append(_trans_solve(states[n], f1d[t], qaux, n, t, hdt / dx[t], L,
                                              coord, cfg, masks[n]))
                continue
            geom_terms = None
            if rz:
                geom_terms = {"area": geom.face_area(t, cfg.ng), "vol": geom.volume(cfg.ng)}
            qm_c, qp_c = trans_single(states[n][0], states[n][1], f1d[t][0], f1d[t][1],
                                      qaux, n, t, hdt / dx[t], L, cfg.small_pres, *reset,
                                      geom_terms=geom_terms, hdt=hdt,
                                      radial_p_fix=rz and t == 0 and not mom_flux_has_p(0, coord),
                                      use_kernels=kern, use_eos=trans_eos)
            fluxes_qe.append(solve(qm_c, qp_c, n))
        del f1d
    else:
        # 3D full corner coupling (reference Castro_ctu_hydro.cpp:700-1150)
        third = dt / 3.0
        hdt = 0.5 * dt
        f1d = [solve(states[d][0], states[d][1], d) for d in range(3)]
        # F^{n|t} from the corner-coupled states q{n}|{t}
        fint = {}
        for n in range(3):
            for t in range(3):
                if t == n:
                    continue
                qm_c, qp_c = trans_single(
                    states[n][0], states[n][1], f1d[t][0], f1d[t][1], qaux, n, t,
                    third / dx[t], L, cfg.small_pres, *reset, use_kernels=kern,
                    use_eos=trans_eos)
                fint[(n, t)] = solve(qm_c, qp_c, n)
                del qm_c, qp_c
        del f1d
        # final states: q{n} corrected by F^{t1|t2} and F^{t2|t1}
        fluxes_qe = []
        for n in range(3):
            t1, t2 = [d for d in range(3) if d != n]
            qm_f, qp_f = trans_final(
                states[n][0], states[n][1], fint[(t1, t2)][0], fint[(t1, t2)][1],
                fint[(t2, t1)][0], fint[(t2, t1)][1], qaux, n, t1, t2,
                hdt / dx[t1], hdt / dx[t2], L, cfg.small_pres, *reset, use_kernels=kern,
                use_eos=trans_eos)
            fluxes_qe.append(solve(qm_f, qp_f, n))
            del qm_f, qp_f
        del fint
    del states
    fluxes = [fq[0] for fq in fluxes_qe]
    qes = [fq[1] for fq in fluxes_qe]

    if kern and dim == 3 and not limiters:
        # one consup launch per direction, accumulated over 0, 1, 2; the
        # last emits u + dt*hsrc
        hsrc = torch.zeros_like(u)
        for d in range(3):
            fin = fold_update_dt if d == 2 else None
            hsrc, fluxes[d] = K.consup(hsrc, fluxes[d], qes[d][L.GDPRES],
                                       qes[d][(L.GDU, L.GDV, L.GDW)[d]], div_node, u, d, L,
                                       cfg.difmag, dx, finalize_dt=fin)
        return _finish(hsrc, u, shk, dt, fold_update_dt, fluxes, qes, geom, L, cfg)
    return _update(u, q, fluxes, qes, shk, dt, div_node, geom, L, cfg, fold_update_dt)


def _finish(hsrc, u, shk, dt, fold_update_dt, fluxes, qes, geom, L, cfg):
    """The tail of the kernel structure's consup (`castro_tpu/ops/ctu.py:
    405-422`): temperature and the shock flag are set, not fluxed (USHK to
    the flag itself when the update is folded), then the hybrid momenta."""
    if fold_update_dt is None:
        hsrc[L.UTEMP] = 0.0
        if cfg.use_shock_var:
            hsrc[L.USHK] = (shk - u[L.USHK]) / max(float(dt), 1e-300)
    elif cfg.use_shock_var:
        hsrc[L.USHK] = shk
    if _use_hybrid(cfg, L, geom):
        hsrc = _apply_hybrid(hsrc, 1.0 if fold_update_dt is None else
                             K.wt(fold_update_dt, u.dtype), fluxes, qes, geom, L, cfg)
    return hsrc, fluxes, qes, shk


def _use_hybrid(cfg, L, geom):
    return cfg.hybrid_hydro and L.hybrid_momentum and geom.coord == CoordSys.CARTESIAN


def _apply_hybrid(target, factor, fluxes, qes, geom, L, cfg):
    """Add the hybrid-momentum flux divergence (hybrid_hydro=1,
    Castro_hybrid.cpp / hybrid.H compute_hybrid_flux) times `factor` into
    `target` (hsrc, or the folded u + dt*hsrc), record the hybrid rows in
    `fluxes` for refluxing, and subtract the radial pressure gradient from
    the face Godunov pressures (Castro_ctu_hydro.cpp:1280-1300)."""
    from castro_tpu_torch.ops.hybrid import R_MIN, _loc, hybrid_flux

    dim, dx = L.dim, geom.dx
    target = target.clone()
    for d in range(dim):
        fr, fl, fp = hybrid_flux(qes[d], d, geom, L, cfg.ng)
        fluxes[d] = fluxes[d].clone()
        for comp, F in ((L.UMR, fr), (L.UML, fl), (L.UMP, fp)):
            div = (F - shifted(F, 1, d)) / dx[d]
            target[comp] = target[comp] + factor * div
            fluxes[d][comp] = F
    grid_shape = tuple(target.shape[1:])
    loc = _loc(geom, L, cfg.ng, grid_shape, target.dtype)
    R = torch.clamp(torch.sqrt(loc[0] ** 2 + loc[1] ** 2), min=R_MIN)
    gradp = 0.0
    for d in range(min(dim, 2)):
        gdp = qes[d][L.GDPRES]
        gradp = gradp + (loc[d] / R) * (shifted(gdp, 1, d) - gdp) / dx[d]
    target[L.UMR] = target[L.UMR] - factor * gradp
    return target


def _update(u, q, fluxes, qes, shk, dt, div_node, geom, L, cfg, fold_update_dt):
    """Artificial viscosity, the flux limiters and species normalization of
    each direction's flux, then the conservative update (consup_hydro,
    Castro_ctu.cpp:12) with p div u and, on a curvilinear grid, the radial
    pressure gradient its momentum flux left out, in torch ops
    (`castro_tpu/ops/ctu.py:424-480`). Returns (hsrc or u + dt*hsrc,
    fluxes, qes, shk)."""
    dim = L.dim
    dx = geom.dx
    curvilinear = geom.coord != CoordSys.CARTESIAN
    # reference flux-clean block, Castro_ctu_hydro.cpp:1150
    for d in range(dim):
        fluxes[d] = au.apply_av(fluxes[d], d, div_node, u, L, cfg.difmag, dx)
        if cfg.limit_fluxes_on_small_dens:
            fluxes[d] = au.limit_hydro_fluxes_on_small_dens(
                fluxes[d], d, u, q, geom, L, dt, cfg.cfl, cfg.small_dens, cfg.ng)
        if cfg.speed_limit > 0.0:
            fluxes[d] = au.limit_hydro_fluxes_on_large_vel(
                fluxes[d], d, u, q, geom, L, dt, cfg.cfl, cfg.speed_limit, cfg.ng)
        fluxes[d] = au.normalize_species_fluxes(fluxes[d], L)

    # fluxes times area/volume (~1/dx), which keeps cgs products inside
    # float32; on radial faces of a curvilinear grid the area varies along
    # the face axis, so the hi face takes the area at i+1
    volinv = 1.0 / geom.volume(cfg.ng)
    hsrc = torch.zeros_like(u)
    pdivu = torch.zeros(tuple(u.shape[1:]), dtype=u.dtype, device=u.device)
    for d in range(dim):
        area = geom.face_area(d, cfg.ng)
        av_lo = area * volinv
        av_hi = shifted(area, 1, d) * volinv if curvilinear and d == 0 else av_lo
        hsrc = hsrc + (av_lo * fluxes[d] - av_hi * shifted(fluxes[d], 1, 1 + d))
        gdu = qes[d][(L.GDU, L.GDV, L.GDW)[d]]
        gdp = qes[d][L.GDPRES]
        pdivu = pdivu + 0.5 * (shifted(gdp, 1, d) + gdp) * (shifted(gdu, 1, d) * av_hi
                                                            - gdu * av_lo)
    hsrc[L.UEINT] = hsrc[L.UEINT] - pdivu
    hsrc[L.UTEMP] = 0.0
    if not mom_flux_has_p(0, geom.coord):
        gdp0 = qes[0][L.GDPRES]
        hsrc[L.UMX] = hsrc[L.UMX] + (-(shifted(gdp0, 1, 0) - gdp0) / dx[0])
    if cfg.use_shock_var:
        # USHK is set, not fluxed (consup_hydro n==USHK branch)
        hsrc[L.USHK] = (shk - u[L.USHK]) / max(float(dt), 1e-300)
    if _use_hybrid(cfg, L, geom):
        hsrc = _apply_hybrid(hsrc, 1.0, fluxes, qes, geom, L, cfg)
    if fold_update_dt is not None:
        hsrc = u + K.wt(fold_update_dt, u.dtype) * hsrc
    return hsrc, fluxes, qes, shk


def _trans_solve(state, f_t, qaux, n, t, cdtdx, L, coord, cfg, mask):
    """The 2D final stage of normal n as one `trans_cmpflx` launch: both
    states corrected by the t-direction flux difference, then solved."""
    term = [{"flux": f_t[0], "qe": f_t[1], "t_dir": t, "cdtdx": cdtdx}]
    df_p, dre_p, dp_p = term_bundle(term, qaux, n, 0, L)
    df_m, dre_m, dp_m = term_bundle(term, qaux, n, -1, L)
    c, g = qaux[L.QC], qaux[L.QGAMC]
    return K.trans_cmpflx(state[0], state[1], df_m, df_p, dre_m, dre_p, dp_m, dp_p,
                          shifted(g, -1, n), g, shifted(c, -1, n), c, n, L, coord,
                          cfg.riemann_solver, cfg.small_dens, cfg.small_pres,
                          cfg.transverse_reset_density, cfg.transverse_reset_rhoe,
                          bnd_mask=mask)


def _ctu_kernels(u, q, qaux, srcQ, dt, dx, flatn, div_node, masks, L, cfg, fold_update_dt,
                 trace, consup=True):
    """The 3D kernel structure of riemann_solver 0 or 2: the 1D solves (PPM:
    fused into the 3 trace launches; PLM: the torch-op trace, then 3
    `ctu_face` launches with terms=[]), 3 paired corner launches and 3
    final launches, which fold consup unless `consup` is false (the flux
    limiters clean the fluxes first). Returns (hsrc or u + dt*hsrc, or
    None without consup; fluxes; qes)."""
    third = dt / 3.0
    hdt = 0.5 * dt

    def face(n, terms, **kw):
        return K.ctu_face(states[n][0], states[n][1], qaux, n, terms, L, 0,
                          cfg.riemann_solver, cfg.small_dens, cfg.small_pres,
                          cfg.transverse_reset_density, cfg.transverse_reset_rhoe,
                          bnd_mask=masks[n], **kw)

    if cfg.ppm_type == 0:
        states = [trace(d) for d in range(3)]
        f1d = [face(d, []) for d in range(3)]
    else:
        res = [K.trace_ppm(q, qaux, srcQ, flatn, d, dt, dx[d], L, cfg.small_dens,
                           cfg.small_pres, cfg.small_ener,
                           fuse_riemann=dict(coord=0, riemann_solver=cfg.riemann_solver,
                                             bnd_mask=masks[d]))
               for d in range(3)]
        states = [(r[0], r[1]) for r in res]
        f1d = [(r[2], r[3]) for r in res]
        del res

    fint = {}
    for n in range(3):
        t1, t2 = [t for t in range(3) if t != n]

        def term(t):
            return {"flux": f1d[t][0], "qe": f1d[t][1], "t_dir": t, "cdtdx": third / dx[t]}

        # both corner stages with normal n share one read of (qm, qp, qaux)
        fint[(n, t1)], fint[(n, t2)] = face(n, [term(t1)], terms2=[term(t2)])
    del f1d
    # the final stage of each normal, with its consup pass folded in; hsrc
    # accumulates over normals 0, 1, 2 and normal 2 emits u + dt*hsrc
    fluxes, qes = [], []
    hsrc = torch.zeros_like(u) if consup else None
    for n in range(3):
        t1, t2 = [d for d in range(3) if d != n]
        terms = [
            {"flux": fint[(t1, t2)][0], "qe": fint[(t1, t2)][1], "t_dir": t1,
             "cdtdx": hdt / dx[t1]},
            {"flux": fint[(t2, t1)][0], "qe": fint[(t2, t1)][1], "t_dir": t2,
             "cdtdx": hdt / dx[t2]},
        ]
        if consup:
            fin = fold_update_dt if n == 2 else None
            (f, qe), hsrc = face(n, terms, consup=dict(hsrc=hsrc, div_node=div_node, u=u,
                                                       difmag=cfg.difmag, dx=dx,
                                                       finalize_dt=fin))
        else:
            f, qe = face(n, terms)
        fluxes.append(f)
        qes.append(qe)
    if consup and fold_update_dt is None:
        hsrc[L.UTEMP] = 0.0
    return hsrc, fluxes, qes
