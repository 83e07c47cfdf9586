"""Sedov-Taylor blast wave (reference `Exec/hydro_tests/Sedov`; counterpart
of `castro_tpu/problems/sedov.py`): point energy E deposited in a small
sphere of radius r_init in a cold uniform ambient medium."""

from __future__ import annotations

import math

import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.ops.stencil import interior_slice
from castro_tpu_torch.problems.util import fill_from_prim

DEFAULTS = dict(r_init=0.01, p_ambient=1e-5, dens_ambient=1.0, exp_energy=1.0,
                nsub=4)


def make_params(n=64, dim=2, gamma=1.4, coord=0, prob_hi=1.0, stop_time=0.01,
                dtype="float64", **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=(n,) * dim, max_step=100000, stop_time=stop_time)
    p = p.with_ns("geometry", coord_sys=coord, prob_lo=(0.0,) * 3,
                  prob_hi=(prob_hi,) * 3)
    p = p.with_ns("castro", lo_bc=(2, 2, 2), hi_bc=(2, 2, 2), cfl=0.5,
                  small_temp=1e-12, small_dens=1e-12, small_pres=1e-20)
    p = p.with_ns("eos", eos_gamma=gamma)
    p = p.with_ns("tpu", dtype=dtype)
    merged = dict(DEFAULTS)
    merged.update(prob)
    return p.replace(problem=merged)


def problem_init(sim, u, center=None):
    """Deposit E_exp in a sphere, smoothed over one cell width with a tanh
    ramp and renormalized so that exactly exp_energy is deposited."""
    pp = dict(DEFAULTS)
    pp.update(sim.params.problem)
    g = sim.geom
    dim = g.dim
    if center is None:
        # blast at the domain center; with symmetry BCs at the corner/axis
        center = tuple(0.0 if sim.params.castro.lo_bc[d] in (3, 4, 5) else
                       0.5 * (g.prob_lo[d] + g.prob_hi[d]) for d in range(dim))
    r = g.radius(sim.ng, center=center)

    r_init = pp["r_init"]
    if dim == 3 or (dim == 1 and g.coord == 2) or (dim == 2 and g.coord == 1):
        vol = 4.0 / 3.0 * math.pi * r_init ** 3
    elif dim == 2:
        vol = math.pi * r_init ** 2
    else:
        vol = 2.0 * r_init
    e_in = pp["exp_energy"] / vol

    w = 0.5 * min(g.dx)
    inside = 0.5 * (1.0 - torch.tanh((r - r_init) / w))

    vol = g.volume(sim.ng).expand(inside.shape)
    inner = interior_slice(sim.ng, dim, comp_ndim=0)
    e_raw = torch.sum((e_in * inside * vol)[inner])
    scale = pp["exp_energy"] / torch.clamp(e_raw, min=1e-300)

    gamma = sim.eos.gamma
    p_in = (gamma - 1.0) * e_in * scale
    p = pp["p_ambient"] + (p_in - pp["p_ambient"]) * inside
    rho = torch.full(r.shape, float(pp["dens_ambient"]), dtype=u.dtype, device=u.device)
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), p=p)
