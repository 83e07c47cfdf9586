"""Per-variant times of the two face kernels, trace_ppm and ctu_face, and
of the standalone consup.

    python -m castro_tpu_torch.scripts.prof_faces [n=128] [reps=20] [nspec=1] [dtype=float32]
                                                  [device=cpu]

From the 3D Sedov state of bench.py (n^3 interior, float32; r_init 0.1,
exp_energy 0.5) one step after init, the plain versions make every input.
Then it times, direction by direction, each variant that a step structure
launches: trace_ppm with the 1D solve (the fused step) and without it (the
unfused step); ctu_face's corner pair and final stage with consup (the
fused step), terms=[] (PLM) and the final stage alone (the flux limiters);
then consup alone, one line for each direction, on the same fluxes (the
unfused step's three launches, finalizing on d = 2). `nspec` > 1 gives
the state that many species (NPASS = nspec); dtype=float64 casts every
input to float64. Each time is the mean of `reps`
back-to-back calls of the wrapper (CUDA events), beside the variant's
byte bound: each input read once and each output written once at 3.35
TB/s. Every line carries the card's name and power limit. On the card
unless device=cpu, where the plain versions run and the times are the
CPU's. The file runs against another checkout's package too
(`PYTHONPATH=<checkout> python <this file>`), whose consup wrapper has the
same signature.
"""

from __future__ import annotations

import sys

import torch

from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.ops.ctu import _bnd_masks
from castro_tpu_torch.problems import sedov
from castro_tpu_torch.scripts.common import card_label, mean_ms, parse_args

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published


# inert species of a layout with more than one (general_null's table)
SPECIES = ("He4", "C12", "O16", "Ne20", "Mg24", "Si28", "Fe56")


def setup(n=128, device=None, nspec=1):
    """Every face-kernel input of one fused step: dict(q, qaux, div, flatn,
    masks, tr (the plain fused traces of the three directions), u, hsrc,
    dt, dx, layout, cfg). With `nspec` > 1 the state carries that many
    inert species (the first holds all the mass), the layout of a reacting
    network of that size."""
    params = sedov.make_params(n=n, dim=3, stop_time=1.0, r_init=0.1, exp_energy=0.5,
                               dtype="float32")
    if nspec > 1:
        params = params.with_ns("network", spec_names=tuple(
            SPECIES[i % len(SPECIES)] + ("" if i < len(SPECIES) else str(i))
            for i in range(nspec)))
    sim = Simulation(params, problem_init=sedov.problem_init, device=device)
    sim.init_data()
    dt = sim.estimate_dt()
    sim.advance(dt)
    L, cfg, dx, u = sim.layout, sim.cfg, sim.geom.dx, sim.u
    q, qaux, div = K.prim_aux_plain(u, L, sim.eos, cfg.small_dens, sim.small_temp, dx)
    flatn = K.flatten_plain(q, L)
    masks = _bnd_masks(u.shape[1:], 3, sim.ng, cfg.lo_bc, cfg.hi_bc)
    tr = [K.trace_ppm_plain(q, qaux, None, flatn, d, dt, dx[d], L, cfg.small_dens,
                            cfg.small_pres, cfg.small_ener,
                            fuse_riemann=dict(coord=0, riemann_solver=0, bnd_mask=masks[d]))
          for d in range(3)]
    return dict(q=q, qaux=qaux, div=div, flatn=flatn, masks=masks, tr=tr, u=u,
                hsrc=torch.zeros_like(u), dt=dt, dx=dx, layout=L, cfg=cfg, eos=sim.eos,
                small_temp=sim.small_temp, ng=sim.ng)


def variants(x):
    """[(kernel, variant, d, kernel call, plain call, components moved a
    cell)] for every variant and direction, at the inputs `x`."""
    L, cfg, dt, dx, tr = x["layout"], x["cfg"], x["dt"], x["dx"], x["tr"]
    nq, nv, ne = L.NQ, L.NVAR, L.NGDNV
    out = []
    for d in range(3):
        t1, t2 = [t for t in range(3) if t != d]
        ta = (x["q"], x["qaux"], None, x["flatn"], d, dt, dx[d], L, cfg.small_dens,
              cfg.small_pres, cfg.small_ener)
        fr = dict(coord=0, riemann_solver=0, bnd_mask=x["masks"][d])
        # q, gamc and c, flatn in; qm, qp [, flux, qe] out
        out.append(("trace_ppm", "with the solve", d,
                    lambda ta=ta, fr=fr: K.trace_ppm(*ta, fuse_riemann=fr),
                    lambda ta=ta, fr=fr: K.trace_ppm_plain(*ta, fuse_riemann=fr),
                    nq + 2 + 1 + 2 * nq + nv + ne))
        out.append(("trace_ppm", "without the solve", d, lambda ta=ta: K.trace_ppm(*ta),
                    lambda ta=ta: K.trace_ppm_plain(*ta), nq + 2 + 1 + 2 * nq))

        def term(t, f):
            return {"flux": tr[t][2], "qe": tr[t][3], "t_dir": t, "cdtdx": f * dt / dx[t]}

        fa = (tr[d][0], tr[d][1], x["qaux"], d)
        fb = (L, 0, 0, cfg.small_dens, cfg.small_pres, True, False)
        fin = [term(t1, 0.5), term(t2, 0.5)]
        cs = dict(hsrc=x["hsrc"], div_node=x["div"], u=x["u"], difmag=cfg.difmag, dx=dx,
                  finalize_dt=dt if d == 2 else None)
        # qm, qp, gamc and c in, and per term its flux, pg and u_t; flux and
        # qe out per stage; consup adds hsrc, div and u in and hsrc' out
        for variant, terms, kw, comps in (
                ("corner pair", [term(t1, 1 / 3)], dict(terms2=[term(t2, 1 / 3)]),
                 2 * nq + 2 + 2 * (nv + 2) + 2 * (nv + ne)),
                ("final + consup", fin, dict(consup=cs),
                 2 * nq + 2 + 2 * (nv + 2) + 2 * nv + 1 + nv + nv + ne),
                ("terms=[]", [], {}, 2 * nq + 2 + nv + ne),
                ("final alone", fin, {}, 2 * nq + 2 + 2 * (nv + 2) + nv + ne)):
            kw = dict(kw, bnd_mask=x["masks"][d])
            out.append(("ctu_face", variant, d,
                        lambda fa=fa, t=terms, kw=kw: K.ctu_face(*fa, t, *fb, **kw),
                        lambda fa=fa, t=terms, kw=kw: K.ctu_face_plain(*fa, t, *fb, **kw),
                        comps))
    return out


def cast(x, dtype):
    """The inputs `x` with every float32 tensor in them cast to `dtype`."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.dtype == torch.float32 else x
    if isinstance(x, dict):
        return {k: cast(v, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(cast(v, dtype) for v in x)
    return x


def consup_variants(x):
    """[(d, kernel call, plain call, components moved a cell)] of the
    standalone consup in each direction, as the unfused step launches it:
    hsrc, flux and u [NVAR], pg, ug and div in; hsrc' and flux' out."""
    L, cfg, dt, dx, tr = x["layout"], x["cfg"], x["dt"], x["dx"], x["tr"]
    out = []
    for d in range(3):
        cs = (x["hsrc"], tr[d][2], tr[d][3][L.GDPRES], tr[d][3][L.GDU + d], x["div"], x["u"],
              d, L, cfg.difmag, dx)
        fin = dt if d == 2 else None
        out.append((d, lambda cs=cs, fin=fin: K.consup(*cs, finalize_dt=fin),
                    lambda cs=cs, fin=fin: K.consup_plain(*cs, finalize_dt=fin),
                    5 * L.NVAR + 3))
    return out


def bound_ms(x, comps):
    """The byte bound of a variant that moves `comps` components a cell."""
    u = x["u"]
    return comps * u[0].numel() * u.element_size() / HBM_BYTES_PER_S * 1e3


def run(x, reps=20, out=print):
    """Time every variant in every direction, then consup alone; returns
    {(kernel, variant, d): ms}."""
    device = x["u"].device
    label = card_label(device)
    res = {}
    rows = [(name, variant, d, kern, comps) for name, variant, d, kern, _, comps in variants(x)]
    rows += [("consup", "alone", d, kern, comps) for d, kern, _, comps in consup_variants(x)]
    for name, variant, d, kern, comps in rows:
        ms = mean_ms(kern, device, reps)
        res[(name, variant, d)] = ms
        bound = bound_ms(x, comps)
        out(f"{name:10s} {variant:18s} d={d} {ms:8.4f} ms  bound {bound:.4f} ms "
            f"({comps} components a cell, {bound / ms:.3f} of it; NPASS "
            f"{x['layout'].nspec + x['layout'].naux}, {str(x['u'].dtype)[6:]})  [{label}]")
    return res


def main(argv=None):
    a = parse_args(sys.argv[1:] if argv is None else argv, n=128, reps=20, nspec=1,
                   dtype="float32")
    x = setup(a["n"], a["device"], nspec=a["nspec"])
    run(cast(x, getattr(torch, a["dtype"])), reps=a["reps"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
