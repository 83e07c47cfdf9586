"""The CTU (corner transport upwind) unsplit Godunov hydro update, 3D.

Counterpart of `castro_tpu/ops/ctu.py` (reference `construct_ctu_hydro_source`,
`Source/hydro/Castro_ctu_hydro.cpp:17-1528`): ctoprim -> flatten ->
PPM trace per dim -> 1D Riemann -> six corner-coupled transverse stages ->
three final stages -> artificial viscosity, species flux normalization and
the conservative update with p div(u).

Two structures compute the same update:
- the kernel structure (`cfg.use_kernels`, the JAX package's fused Pallas
  structure `ctu.py:185-325`): the trace kernel emits the 1D fluxes, one
  `ctu_face` launch per normal pairs its two corner stages, and the final
  stage of each normal folds its consup pass, normal 2 emitting
  u + dt*hsrc. It runs on the card through the CUDA kernels and on the CPU
  through their plain versions;
- the plain structure (the JAX package's XLA path, `ctu.py:326-358`,
  `:424-480`) of separate trace, Riemann, transverse and consup passes.

The 1D and 2D branches, PLM, hybrid Riemann, shock variables, curvilinear
coordinates and the flux limiters are not ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from castro_tpu_torch.geometry import CoordSys
from castro_tpu_torch.ops import advection_util as au
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops.fill import WALLS
from castro_tpu_torch.ops.flatten import uflatten
from castro_tpu_torch.ops.riemann import WallMask, cmpflx
from castro_tpu_torch.ops.stencil import shifted
from castro_tpu_torch.ops.trace_ppm import trace_ppm
from castro_tpu_torch.ops.trans import trans_final, trans_single


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


def _check_supported(geom, layout, cfg):
    if layout.dim != 3:
        raise NotImplementedError("only the 3D CTU branch is ported (ROADMAP.md, queue 1 item 4)")
    if geom.coord != CoordSys.CARTESIAN:
        raise NotImplementedError("curvilinear CTU is not ported (ROADMAP.md, queue 1 item 4)")
    if cfg.ppm_type == 0:
        raise NotImplementedError("PLM tracing is not ported (ROADMAP.md, queue 1 item 4)")
    if layout.shock_var or layout.hybrid_momentum:
        raise NotImplementedError(
            "shock variables and hybrid momenta are not ported (ROADMAP.md, queue 1 item 4)")


def ctu_hydro(u, q, qaux, srcQ, dt, geom, layout, cfg: HydroConfig,
              div_node=None, fold_update_dt=None):
    """The CTU hydro update of grown, ghost-filled arrays.

    Returns (hsrc [NVAR], or u + fold_update_dt*hsrc when given; the final
    fluxes per dim [NVAR, faces]; the Godunov states per dim [NGDNV,
    faces]). The interior is valid; the ghost margin is garbage."""
    L = layout
    _check_supported(geom, L, cfg)
    dx = geom.dx
    grid_shape = tuple(q.shape[1:])
    dt = K.wt(dt, q.dtype)
    if cfg.use_flattening:
        flatn = K.flatten(q, L) if cfg.use_kernels else uflatten(q, L)
    else:
        flatn = torch.ones(grid_shape, dtype=q.dtype, device=q.device)
    if div_node is None:
        div_node = au.divu_node(q, dx, L)
    masks = _bnd_masks(grid_shape, 3, cfg.ng, cfg.lo_bc, cfg.hi_bc)
    third = dt / 3.0
    hdt = 0.5 * dt
    if cfg.use_kernels:
        return _ctu_kernels(u, q, qaux, srcQ, dt, dx, geom.coord, flatn, div_node,
                            masks, third, hdt, L, cfg, fold_update_dt)

    def solve(qm, qp, d):
        return cmpflx(qm, qp, qaux, d, L, geom.coord, riemann_solver=cfg.riemann_solver,
                      small_dens=cfg.small_dens, small_pres=cfg.small_pres,
                      bnd_mask=masks[d])

    states = [trace_ppm(q, qaux, srcQ, flatn, d, dt, dx[d], L, cfg.small_dens,
                        cfg.small_pres, cfg.small_ener) for d in range(3)]
    f1d = [solve(states[d][0], states[d][1], d) for d in range(3)]
    # corner-coupled states q{n}|{t}
    fint = {}
    for n in range(3):
        for t in range(3):
            if t == n:
                continue
            qm_c, qp_c = trans_single(
                states[n][0], states[n][1], f1d[t][0], f1d[t][1], qaux, n, t,
                third / dx[t], L, cfg.small_pres, cfg.transverse_reset_density,
                cfg.transverse_reset_rhoe)
            fint[(n, t)] = solve(qm_c, qp_c, n)
    # final states: q{n} corrected by F^{t1|t2} and F^{t2|t1}
    fluxes, qes = [], []
    for n in range(3):
        t1, t2 = [d for d in range(3) if d != n]
        qm_f, qp_f = trans_final(
            states[n][0], states[n][1], fint[(t1, t2)][0], fint[(t1, t2)][1],
            fint[(t2, t1)][0], fint[(t2, t1)][1], qaux, n, t1, t2,
            hdt / dx[t1], hdt / dx[t2], L, cfg.small_pres,
            cfg.transverse_reset_density, cfg.transverse_reset_rhoe)
        f, qe = solve(qm_f, qp_f, n)
        fluxes.append(f)
        qes.append(qe)

    # artificial viscosity + species flux normalization
    for d in range(3):
        fluxes[d] = au.apply_av(fluxes[d], d, div_node, u, L, cfg.difmag, dx)
        fluxes[d] = au.normalize_species_fluxes(fluxes[d], L)

    # conservative update (consup_hydro, Castro_ctu.cpp:12): fluxes times
    # area/volume (~1/dx), which keeps cgs products inside float32
    volinv = 1.0 / geom.volume(cfg.ng)
    hsrc = torch.zeros_like(u)
    pdivu = torch.zeros(grid_shape, dtype=q.dtype, device=q.device)
    for d in range(3):
        av = geom.face_area(d, cfg.ng) * volinv
        hsrc = hsrc + (av * fluxes[d] - av * shifted(fluxes[d], 1, 1 + d))
        gdu = qes[d][(L.GDU, L.GDV, L.GDW)[d]]
        gdp = qes[d][L.GDPRES]
        pdivu = pdivu + 0.5 * (shifted(gdp, 1, d) + gdp) * (shifted(gdu, 1, d) * av - gdu * av)
    hsrc[L.UEINT] = hsrc[L.UEINT] - pdivu
    hsrc[L.UTEMP] = 0.0
    if fold_update_dt is not None:
        hsrc = u + K.wt(fold_update_dt, u.dtype) * hsrc
    return hsrc, fluxes, qes


def _ctu_kernels(u, q, qaux, srcQ, dt, dx, coord, flatn, div_node, masks, third,
                 hdt, L, cfg, fold_update_dt):
    """The kernel structure: 3 trace + 3 paired corner + 3 final launches."""
    res = [K.trace_ppm(q, qaux, srcQ, flatn, d, dt, dx[d], L, cfg.small_dens,
                       cfg.small_pres, cfg.small_ener,
                       fuse_riemann=dict(coord=coord, riemann_solver=cfg.riemann_solver,
                                         bnd_mask=masks[d]))
           for d in range(3)]
    states = [(r[0], r[1]) for r in res]
    f1d = [(r[2], r[3]) for r in res]

    def face(n, terms, **kw):
        return K.ctu_face(states[n][0], states[n][1], qaux, n, terms, L, coord,
                          cfg.riemann_solver, cfg.small_dens, cfg.small_pres,
                          cfg.transverse_reset_density, cfg.transverse_reset_rhoe,
                          bnd_mask=masks[n], **kw)

    fint = {}
    for n in range(3):
        t1, t2 = [t for t in range(3) if t != n]

        def term(t):
            return {"flux": f1d[t][0], "qe": f1d[t][1], "t_dir": t, "cdtdx": third / dx[t]}

        # both corner stages with normal n share one read of (qm, qp, qaux)
        fint[(n, t1)], fint[(n, t2)] = face(n, [term(t1)], terms2=[term(t2)])
    del f1d, res
    # the final stage of each normal with its consup pass folded in; hsrc
    # accumulates over normals 0, 1, 2 and normal 2 emits u + dt*hsrc
    fluxes, qes = [], []
    hsrc = torch.zeros_like(u)
    for n in range(3):
        t1, t2 = [d for d in range(3) if d != n]
        terms = [
            {"flux": fint[(t1, t2)][0], "qe": fint[(t1, t2)][1], "t_dir": t1,
             "cdtdx": hdt / dx[t1]},
            {"flux": fint[(t2, t1)][0], "qe": fint[(t2, t1)][1], "t_dir": t2,
             "cdtdx": hdt / dx[t2]},
        ]
        fin = fold_update_dt if n == 2 else None
        (f, qe), hsrc = face(n, terms, consup=dict(hsrc=hsrc, div_node=div_node, u=u,
                                                   difmag=cfg.difmag, dx=dx,
                                                   finalize_dt=fin))
        fluxes.append(f)
        qes.append(qe)
    if fold_update_dt is None:
        hsrc[L.UTEMP] = 0.0
    return hsrc, fluxes, qes
