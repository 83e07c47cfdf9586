"""xrb_mixed (counterpart of `castro_tpu/problems/xrb_mixed.py`; reference
`Exec/science/xrb_mixed`): mixed H/He burning on a neutron star's
surface, the toy_xrb accreted layer (a hot ash substrate, a tanh
transition to an H/He fuel column, an isentropic top) with optional seed
vortices (`problem.apply_vel_field`, `problem_initialize_state_data.H`).
rprox burns, through the Helmholtz EOS; g = -2.45e14, a 1536 x 4608 cm
box, as the reference's inputs."""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import column_state, fill_from_prim
from castro_tpu_torch.utils.tmath import vmax

DEFAULTS = dict(dens_base=3.43e6, T_star=1.0e9, T_hi=2.0e8, T_lo=8.0e6, H_star=1450.0,
                atm_delta=12.0, apply_vel_field=1, velpert_height_loc=1475.0,
                velpert_scale=1.0e2, velpert_amplitude=1.0e5, num_vortices=4)
G_CONST = -2.45e14

# rprox's species (network/rprox.py)
IC12, IO14, IO15, IO16, IF17, IMG22, IS30, INI56, IHE4, IH1 = range(10)


def make_params(n=(64, 192), **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=tuple(n))
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(1536.0, 4608.0, 1.0))
    p = p.with_ns("castro", lo_bc=(0, 1), hi_bc=(0, 2), do_grav=1, do_react=1, small_dens=1e-5,
                  small_temp=1e6, cfl=0.5, dtnuc_e=0.25)
    p = p.with_ns("gravity", gravity_type="ConstantGrav", const_grav=G_CONST)
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="rprox", nspec=10)
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(DEFAULTS, **prob))


def vortices(sim, x, y, pp):
    """(vx, vy): a row of num_vortices counter-rotating vortices at
    velpert_height_loc (the reference's vortex loop), or zero without
    apply_vel_field."""
    vx, vy = torch.zeros_like(x), torch.zeros_like(x)
    if not pp["apply_vel_field"]:
        return vx, vy
    g = sim.geom
    nv = int(pp["num_vortices"])
    dxv = float(g.prob_hi[0] - g.prob_lo[0]) / nv
    scale, amp = pp["velpert_scale"], pp["velpert_amplitude"]
    ydist = y - pp["velpert_height_loc"]
    for m in range(nv):
        xdist = x - (float(g.prob_lo[0]) + (m + 0.5) * dxv)
        r = torch.sqrt(xdist ** 2 + ydist ** 2)
        sgn = 1.0 if m % 2 == 0 else -1.0
        w = amp * torch.exp(-ydist ** 2 / (2.0 * scale ** 2))
        rr = vmax(r, 1e-8)
        vx = vx + sgn * w * (ydist / rr) * torch.exp(-r / scale)
        vy = vy - sgn * w * (xdist / rr) * torch.exp(-r / scale)
    return vx, vy


def layered_init(sim, u, pp, xn_star, xn_base, g_const):
    """The toy_atm layer of xrb_mixed and nova on u's grid, with the seed
    vortices."""
    from castro_tpu_torch.utils.initial_models import toy_atm

    z1 = sim.geom.cell_centers_1d(1, sim.ng).double().cpu().numpy()
    model = toy_atm(sim.eos, z1, pp["dens_base"], pp["T_star"], pp["T_hi"], pp["T_lo"],
                    pp["H_star"], pp["atm_delta"], xn_star, xn_base, g_const)
    rho, T, xn = column_state(sim, u, model)
    x = sim.geom.cell_centers(0, sim.ng).expand(rho.shape).to(torch.float64)
    y = sim.geom.cell_centers(1, sim.ng).expand(rho.shape).to(torch.float64)
    vx, vy = vortices(sim, x, y, pp)
    return fill_from_prim(sim, u, rho, (vx, vy, 0.0), T=T, xn=xn)


def problem_init(sim, u):
    pp = dict(DEFAULTS, **sim.params.problem)
    xn_star = np.zeros(sim.layout.nspec)
    xn_star[INI56] = 1.0  # the neutron star's ash substrate
    xn_base = np.zeros(sim.layout.nspec)
    xn_base[IH1] = 0.7  # accreted, roughly solar fuel
    xn_base[IHE4] = 0.28
    xn_base[IC12] = 0.02
    return layered_init(sim, u, pp, xn_star, xn_base, G_CONST)
