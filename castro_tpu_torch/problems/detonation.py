"""Detonation (reference `Exec/science/Detonation`; counterpart of
`castro_tpu/problems/detonation.py`): a 1D reactive shock tube, hot fuel
on the left ignites and the burning front couples to the shock. The
reference runs helmholtz + aprox19; this setup defaults to the powerlaw
model network, as the JAX package's does (swap network/eos through inputs
for the stellar configuration)."""

from __future__ import annotations

import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim

DEFAULTS = dict(T_l=4.0, T_r=0.2, dens=1.0, cfrac=0.0, frac=0.3)


def make_params(n=256, dtype="float64", tim=0):
    p = Params()
    p = p.with_ns("amr", n_cell=(n,))
    p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(4.0,) * 3)
    p = p.with_ns("castro", lo_bc=(2,), hi_bc=(2,), cfl=0.5, do_react=1,
                  time_integration_method=tim,
                  small_dens=1e-12, small_temp=1e-12, small_pres=1e-15)
    p = p.with_ns("network", network_name="powerlaw", rtilde=5.0, specific_q_burn=20.0,
                  T_burn_ref=1.5, rho_burn_ref=1.0, f_act=1.0)
    p = p.with_ns("eos", eos_gamma=1.4)
    p = p.with_ns("tpu", dtype=dtype)
    return p.replace(problem=dict(DEFAULTS))


def problem_init(sim, u):
    pp = dict(DEFAULTS)
    pp.update(sim.params.problem)
    x = sim.geom.cell_centers(0, sim.ng)
    span = sim.geom.prob_hi[0] - sim.geom.prob_lo[0]
    left = x < sim.geom.prob_lo[0] + pp["frac"] * span
    T = torch.where(left, torch.full_like(x, pp["T_l"]), torch.full_like(x, pp["T_r"]))
    xn = torch.zeros((sim.layout.nspec,) + tuple(x.shape), dtype=u.dtype, device=u.device)
    xn[0] = 1.0  # all fuel
    return fill_from_prim(sim, u, pp["dens"], (0.0, 0.0, 0.0), T=T, xn=xn)
