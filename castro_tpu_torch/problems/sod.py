"""Sod shock tube (reference `Exec/hydro_tests/Sod`; counterpart of
`castro_tpu/problems/sod.py`): two constant states separated at `frac` of
the domain along direction `idir` (1-based), in 1, 2 or 3 dimensions."""

from __future__ import annotations

import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim

DEFAULTS = dict(p_l=1.0, u_l=0.0, rho_l=1.0, p_r=0.1, u_r=0.0, rho_r=0.125,
                frac=0.5, idir=1)


def make_params(n=128, dim=1, gamma=1.4, dtype="float64", **prob):
    """inputs analog of Exec/hydro_tests/Sod/inputs-sod-x."""
    p = Params()
    p = p.with_ns("amr", n_cell=(n,) * dim, max_step=10000, stop_time=0.2)
    p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(1.0,) * 3)
    p = p.with_ns("castro", lo_bc=(2, 2, 2), hi_bc=(2, 2, 2), cfl=0.9,
                  small_temp=1e-12, small_dens=1e-12, small_pres=1e-12)
    p = p.with_ns("eos", eos_gamma=gamma)
    p = p.with_ns("tpu", dtype=dtype)
    merged = dict(DEFAULTS)
    merged.update(prob)
    return p.replace(problem=merged)


def problem_init(sim, u):
    pp = dict(DEFAULTS)
    pp.update(sim.params.problem)
    d = pp["idir"] - 1
    x = sim.geom.cell_centers(d, sim.ng)
    split = sim.geom.prob_lo[d] + pp["frac"] * (sim.geom.prob_hi[d] - sim.geom.prob_lo[d])
    left = x < split

    def sides(lval, rval):
        return torch.where(left, torch.full_like(x, lval), torch.full_like(x, rval))

    vel = [0.0, 0.0, 0.0]
    vel[d] = sides(pp["u_l"], pp["u_r"])
    return fill_from_prim(sim, u, sides(pp["rho_l"], pp["rho_r"]), tuple(vel),
                          p=sides(pp["p_l"], pp["p_r"]))
