"""HSE convergence (counterpart of `castro_tpu/problems/hse_convergence.py`;
reference `Exec/gravity_tests/hse_convergence`): a 1D isothermal
hydrostatic atmosphere under constant gravity, gamma law, with HSE ghost
fills on both faces, must stay static: the velocity its truncation error
makes converges away with resolution."""

from __future__ import annotations

import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim

G_CONST = -2.0
RHO_BASE = 1.0
P_BASE = 1.0
GAMMA = 1.4


def make_params(n=64, dtype="float64"):
    p = Params()
    p = p.with_ns("amr", n_cell=(n,), stop_time=1.0)
    p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(1.0,) * 3)
    p = p.with_ns("castro", lo_bc=(1,), hi_bc=(1,), do_grav=1, small_dens=1e-12,
                  small_temp=1e-12, small_pres=1e-15, use_pslope=1, ppm_type=1)
    p = p.with_ns("gravity", gravity_type="ConstantGrav", const_grav=G_CONST)
    p = p.with_ns("eos", eos_gamma=GAMMA)
    return p.with_ns("tpu", dtype=dtype)


def hse_profile(x):
    """Isothermal: p = p0 exp(g x / cs_iso^2), rho = rho0 p / p0."""
    cs2 = P_BASE / RHO_BASE  # the isothermal sound speed squared
    fac = torch.exp(G_CONST * x / cs2)
    return RHO_BASE * fac, P_BASE * fac


def problem_init(sim, u):
    rho, p = hse_profile(sim.geom.cell_centers(0, sim.ng))
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), p=p)


def build(n=64, dtype="float64", device=None):
    """The configured Simulation, with HSE fills on both faces (on the card
    unless `device` says else)."""
    from castro_tpu_torch.driver.sim import Simulation
    from castro_tpu_torch.problems.fills import make_hse_fill

    holder = {}
    sim = Simulation(make_params(n=n, dtype=dtype), problem_init=problem_init, device=device,
                     problem_fill=lambda u, t=0.0: holder["hse"](u))
    holder["hse"] = make_hse_fill(sim, [(0, "lo"), (0, "hi")], G_CONST)
    return sim
