"""toy_flame (counterpart of `castro_tpu/problems/toy_flame.py`; reference
`Exec/reacting_tests/toy_flame`): a 1D laminar flame with the powerlaw
fuel -> ash network and conduction; a hot region on the left ignites a
flame that moves into the fuel at a steady speed. Defaults are the
reference's inputs.1d."""

from __future__ import annotations

import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim

DEFAULTS = dict(rho_fuel=1.0, T_fuel=1.0, pert_frac=0.2, pert_delta=0.05)


def make_params(n=256, **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=(n,), stop_time=0.1)
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(100.0, 1.0, 1.0))
    p = p.with_ns("castro", lo_bc=(2,), hi_bc=(2,), do_react=1, cfl=0.5, diffuse_temp=1,
                  diffuse_cutoff_density=1e-2, small_dens=1e-12, small_temp=1e-12,
                  small_pres=1e-15)
    p = p.replace(extra={"conductivity.const_conductivity": 5.0e9})
    p = p.with_ns("eos", eos_gamma=1.4)
    p = p.with_ns("network", network_name="powerlaw", rtilde=40.0, nu=4.0,
                  specific_q_burn=1.24e8, T_burn_ref=1.0, rho_burn_ref=1.0, f_act=1.2)
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(DEFAULTS, **prob))


def problem_init(sim, u):
    pp = dict(DEFAULTS, **sim.params.problem)
    g = sim.geom
    x = g.cell_centers(0, sim.ng).expand(u.shape[1:])
    length = g.prob_hi[0] - g.prob_lo[0]
    x_pert = g.prob_lo[0] + pp["pert_frac"] * length
    # a smooth hot (ash) region on the left
    f = 0.5 * (1.0 - torch.tanh((x - x_pert) / (pp["pert_delta"] * length)))
    T = pp["T_fuel"] * (1.0 + 2.0 * f)
    rho = pp["rho_fuel"] / (1.0 + 2.0 * f)  # isobaric: rho ~ 1/T for the gamma law
    xn = torch.stack([1.0 - f, f, torch.zeros_like(f)])  # fuel, ash, inert
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), T=T, xn=xn)
