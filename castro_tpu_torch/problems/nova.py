"""nova (counterpart of `castro_tpu/problems/nova.py`; reference
`Exec/science/nova`): an accreted hydrogen envelope on a CO white dwarf's
surface building toward a CNO runaway, with optional seed vortices. The
reference reads the Glasner HSE model; here the layered envelope (a CO
substrate under a solar-composition envelope) comes from the toy_atm
generator through the Helmholtz EOS, and the hot-CNO nova network burns."""

from __future__ import annotations

import numpy as np

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.xrb_mixed import layered_init

DEFAULTS = dict(dens_base=3.0e4, T_star=3.0e7, T_hi=6.0e7, T_lo=1.0e6, H_star=1.0e7,
                atm_delta=2.0e6, apply_vel_field=0, velpert_height_loc=1.2e8,
                velpert_scale=5.0e6, velpert_amplitude=1.0e5, num_vortices=2)
G_CONST = -8.0e8  # GM/R^2 of a ~1.1 Msun white dwarf

# the nova network's species (network/nova.py)
(IH1, IHE3, IHE4, IC12, IC13, IN13, IN14, IN15, IO14, IO15, IO16, IO17,
 IF17, IF18) = range(14)


def make_params(n=(64, 128), **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=tuple(n))
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(2.5e7, 5.0e7, 1.0))
    p = p.with_ns("castro", lo_bc=(0, 1), hi_bc=(0, 2), do_grav=1, do_react=1, small_dens=1e-8,
                  small_temp=1e4, cfl=0.5)
    p = p.with_ns("gravity", gravity_type="ConstantGrav", const_grav=G_CONST)
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="nova", nspec=14)
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(DEFAULTS, **prob))


def problem_init(sim, u):
    pp = dict(DEFAULTS, **sim.params.problem)
    xn_star = np.zeros(sim.layout.nspec)
    xn_star[IC12] = 0.5
    xn_star[IO16] = 0.5
    xn_base = np.zeros(sim.layout.nspec)
    xn_base[IH1] = 0.7
    xn_base[IHE4] = 0.28
    xn_base[IC12] = 0.01
    xn_base[IN14] = 0.01
    return layered_init(sim, u, pp, xn_star, xn_base, G_CONST)
