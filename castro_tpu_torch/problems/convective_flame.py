"""convective_flame (counterpart of `castro_tpu/problems/convective_flame.py`;
reference `Exec/science/convective_flame`): a powerlaw-network flame at
the base of a rotating, conducting toy atmosphere, convection ahead of
the front. Unit-scale: gamma law, the toy_atm model built in place
(`initial_model.H`), the inputs.2d defaults g = -4.2e7 and P_rot = 0.01."""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import column_state, fill_from_prim

DEFAULTS = dict(dens_base=1.0, T_star=0.75, T_hi=1.0, T_lo=1.0e-2, H_star=1.25,
                atm_delta=0.2, dtemp=1.0, low_density_cutoff=1.0e-8)
G_CONST = -4.2e7


def make_params(n=(128, 96), **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=tuple(n))
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(51.2, 38.4, 1.0))
    p = p.with_ns("castro", lo_bc=(3, 3), hi_bc=(2, 2), do_grav=1, do_react=1, do_rotation=1,
                  rotational_period=0.01, diffuse_temp=1, small_dens=1e-10, small_temp=1e-10,
                  small_pres=1e-12, cfl=0.5)
    p = p.with_ns("gravity", gravity_type="ConstantGrav", const_grav=G_CONST)
    p = p.with_ns("eos", eos_gamma=1.4)
    p = p.with_ns("network", network_name="powerlaw", rtilde=100.0, nu=4.0,
                  specific_q_burn=1.0e8, T_burn_ref=1.0, rho_burn_ref=1.0, f_act=1.2)
    p = p.replace(extra={"conductivity.const_conductivity": 5.0e9})
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(DEFAULTS, **prob))


def problem_init(sim, u):
    from castro_tpu_torch.utils.initial_models import toy_atm

    pp = dict(DEFAULTS, **sim.params.problem)
    L, g = sim.layout, sim.geom
    z1 = g.cell_centers_1d(1, sim.ng).double().cpu().numpy()
    # powerlaw species: fuel, ash, inert
    xn_star = np.zeros(L.nspec)
    xn_star[2 if L.nspec > 2 else L.nspec - 1] = 1.0  # the inert substrate
    xn_base = np.zeros(L.nspec)
    xn_base[0] = 1.0  # fuel above
    model = toy_atm(sim.eos, z1, pp["dens_base"], pp["T_star"], pp["T_hi"], pp["T_lo"],
                    pp["H_star"], pp["atm_delta"], xn_star, xn_base, G_CONST)
    rho, T, xn = column_state(sim, u, model)
    x = g.cell_centers(0, sim.ng).expand(rho.shape)
    y = g.cell_centers(1, sim.ng).expand(rho.shape)
    # the hot perturbation at the base of the fuel (problem.dtemp)
    x0 = 0.5 * float(g.prob_hi[0])
    y0 = float(g.prob_lo[1]) + pp["H_star"] + 1.5 * pp["atm_delta"]
    r2 = ((x - x0) / 2.5) ** 2 + ((y - y0) / 2.5) ** 2
    T = T + pp["dtemp"] * xn[0] * torch.exp(-r2)
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), T=T, xn=xn)
