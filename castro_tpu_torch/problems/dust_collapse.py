"""DustCollapse (reference `Exec/gravity_tests/DustCollapse`; counterpart of
`castro_tpu/problems/dust_collapse.py`): the pressureless-limit collapse of
a uniform cold sphere under self-gravity. The analytic solution (Colgate &
White) gives r(t) through the cycloid parameterization, with the free-fall
time t_ff = sqrt(3 pi / (32 G rho_0)).

dim=1: 1D spherical with monopole gravity; dim=3: 3D Cartesian with
Poisson gravity (multipole BCs, outflow)."""

from __future__ import annotations

import math

import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim
from castro_tpu_torch.utils import constants as C

DEFAULTS = dict(rho_0=1.0e9, r_0=6.5e8, p_0=1.0e10, rho_ambient=1.0e0,
                smooth_delta=4.0e7)


def make_params(n=128, dim=1, dtype="float64"):
    p = Params()
    p = p.with_ns("amr", n_cell=(n,) * dim)
    if dim == 1:
        p = p.with_ns("geometry", coord_sys=2, prob_lo=(0.0,) * 3, prob_hi=(1.35e9,) * 3)
        p = p.with_ns("castro", lo_bc=(3,), hi_bc=(2,), do_grav=1, cfl=0.5,
                      small_dens=1e-5, small_temp=1e-12, small_pres=1e-3)
        p = p.with_ns("gravity", gravity_type="MonopoleGrav")
    else:
        p = p.with_ns("geometry", prob_lo=(-1.35e9,) * 3, prob_hi=(1.35e9,) * 3)
        p = p.with_ns("castro", lo_bc=(2,) * dim, hi_bc=(2,) * dim, do_grav=1, cfl=0.5,
                      small_dens=1e-5, small_temp=1e-12, small_pres=1e-3)
        p = p.with_ns("gravity", gravity_type="PoissonGrav")
    p = p.with_ns("eos", eos_gamma=1.6666666666666667)
    p = p.with_ns("tpu", dtype=dtype)
    return p.replace(problem=dict(DEFAULTS))


def problem_init(sim, u):
    pp = dict(DEFAULTS)
    pp.update(sim.params.problem)
    g = sim.geom
    if g.dim == 1:
        r = g.cell_centers(0, sim.ng)
    else:
        r = g.radius(sim.ng, center=(0.0,) * g.dim)
    # the smoothed sphere edge (the reference's tanh profile)
    rho = pp["rho_ambient"] + 0.5 * (pp["rho_0"] - pp["rho_ambient"]) * (
        1.0 - torch.tanh((r - pp["r_0"]) / pp["smooth_delta"]))
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), p=pp["p_0"])


def free_fall_time(rho_0):
    return math.sqrt(3.0 * math.pi / (32.0 * C.Gconst * rho_0))
