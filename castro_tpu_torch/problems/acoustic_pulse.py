"""Acoustic pulse (reference `Exec/hydro_tests/acoustic_pulse`; counterpart of
`castro_tpu/problems/acoustic_pulse.py`): a smooth isentropic density and
pressure bump in a periodic box, the standard problem for measuring the
order of convergence; and its general-EOS variant (reference
`Exec/hydro_tests/acoustic_pulse_general`), an isentropic pressure bump on
the Helmholtz EOS through `utils/initial_models.isentrope_through`, the
reference's eos_input_ps path."""

from __future__ import annotations

import math

import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim

DEFAULTS = dict(rho0=1.4, drho0=0.14, gamma=1.4)


def make_params(n=64, dim=2, dtype="float64"):
    p = Params()
    p = p.with_ns("amr", n_cell=(n,) * dim)
    p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(1.0,) * 3)
    p = p.with_ns("castro", lo_bc=(0,) * dim, hi_bc=(0,) * dim, cfl=0.5,
                  small_temp=1e-12, small_dens=1e-12, small_pres=1e-15)
    p = p.with_ns("eos", eos_gamma=DEFAULTS["gamma"])
    p = p.with_ns("tpu", dtype=dtype)
    return p.replace(problem=dict(DEFAULTS))


def problem_init(sim, u):
    pp = dict(DEFAULTS)
    pp.update(sim.params.problem)
    g = sim.geom
    r2 = 0.0
    for d in range(g.dim):
        x = g.cell_centers(d, sim.ng) - 0.5
        r2 = r2 + x * x
    r = torch.sqrt(r2)
    rho = torch.where(r <= 0.5,
                      pp["rho0"] + pp["drho0"] * torch.exp(-16 * r * r)
                      * torch.cos(math.pi * r) ** 6,
                      pp["rho0"])
    # isentropic: p = (rho/rho0)^gamma
    p = (rho / pp["rho0"]) ** pp["gamma"]
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), p=p)


GEN_DEFAULTS = dict(rho0=5.0e5, T0=3.0e8, dp_fact=1.5, L_pert=2.0e7)


def general_params(n=64, dim=2, dtype="float64", **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=(n,) * dim, stop_time=2.0e-3)
    p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(1.0e8,) * 3)
    p = p.with_ns("castro", lo_bc=(0,) * dim, hi_bc=(0,) * dim, cfl=0.5, small_temp=1e6,
                  small_dens=1e-5)
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="general_null", spec_names=("He4", "C12", "O16"))
    p = p.with_ns("tpu", dtype=dtype)
    return p.replace(problem=dict(GEN_DEFAULTS, **prob))


def general_init(sim, u):
    """The isentropic pressure bump of reacting_convergence on pure He4."""
    import numpy as np

    from castro_tpu_torch.problems.reacting_tests import _uniform_xn, isentropic_bump

    pp = dict(GEN_DEFAULTS, **sim.params.problem)
    xn0 = np.zeros(sim.layout.nspec)
    xn0[0] = 1.0
    rho, T = isentropic_bump(sim, u, pp, xn0)
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), T=T, xn=_uniform_xn(xn0, u))
