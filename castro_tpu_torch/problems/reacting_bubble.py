"""reacting_bubble (counterpart of `castro_tpu/problems/reacting_bubble.py`;
reference `Exec/reacting_tests/reacting_bubble`): temperature-perturbed
bubbles rising and burning in a plane-parallel white-dwarf-like
atmosphere (inputs_2d: g = -1.5e10, three perturbations,
`problem_initialize_state_data.H`). The atmosphere comes from the
plane-parallel HSE generator, isentropic below, through the Helmholtz EOS;
aprox13 burns."""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import column_state, fill_from_prim

DEFAULTS = dict(dens_base=2.6e9, T_base=6.0e8, pert_temp_factor=1.0, pert_rad_factor=1.0)
G_CONST = -1.5e10


def make_params(n=(96, 160), **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=tuple(n))
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(2.16e8, 3.6e8, 1.0))
    p = p.with_ns("castro", lo_bc=(0, 1), hi_bc=(0, 2), do_grav=1, do_react=1, small_dens=1e-2,
                  small_temp=1e6, cfl=0.5, dtnuc_e=0.25)
    p = p.with_ns("gravity", gravity_type="ConstantGrav", const_grav=G_CONST)
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="aprox13", nspec=13)
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(DEFAULTS, **prob))


def problem_init(sim, u):
    from castro_tpu_torch.utils.initial_models import hse_plane_parallel

    pp = dict(DEFAULTS, **sim.params.problem)
    L, g = sim.layout, sim.geom
    z1 = g.cell_centers_1d(1, sim.ng).double().cpu().numpy()
    xn0 = np.zeros(L.nspec)
    xn0[1] = 0.3  # C12
    xn0[2] = 0.7  # O16
    model = hse_plane_parallel(sim.eos, z1, pp["dens_base"], pp["T_base"], G_CONST,
                               lambda z: xn0, isentropic_until=float(z1[0]) + 1.8e8,
                               T_min=1.0e7)
    rho, T, _ = column_state(sim, u, model)
    xn = torch.zeros((L.nspec,) + tuple(rho.shape), dtype=torch.float64, device=u.device)
    xn[1] = xn0[1]
    xn[2] = xn0[2]
    x = g.cell_centers(0, sim.ng).expand(rho.shape)
    y = g.cell_centers(1, sim.ng).expand(rho.shape)
    # three bubbles (the reference's positions scaled to the box)
    for xc, yc in ((5.4e7, 6.5e7), (1.08e8, 8.5e7), (1.62e8, 7.5e7)):
        r1 = torch.sqrt((x - xc) ** 2 + (y - yc) ** 2) / (2.5e6 * pp["pert_rad_factor"])
        T = T * (1.0 + pp["pert_temp_factor"] * (0.150 * (1.0 + torch.tanh(2.0 - r1))))
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), T=T, xn=xn)
