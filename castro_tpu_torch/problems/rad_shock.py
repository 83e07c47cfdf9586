"""Rad2Tshock (counterpart of `castro_tpu/problems/rad_shock.py`; reference
`Exec/radiation_tests/Rad2Tshock`): the Lowrie & Edwards (2008)
non-equilibrium two-temperature radiative shock, a steady shock in
mixed-frame gray rad-hydro (radiation.comoving = 0) between the pre- and
post-shock states of inputs.M2 (Mach 2) or inputs.M5 (Mach 5)."""

from __future__ import annotations

import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim
from castro_tpu_torch.utils import constants as C

# inputs.M2 (Mach 2)
M2 = dict(rho0=5.45969027775e-13, T0=100.0, v0=235435.230236,
          rho1=1.24812608999e-12, T1=207.756999533, v1=102986.665199)
# inputs.M5 (Mach 5)
M5 = dict(rho0=5.45969027775e-13, T0=100.0, v0=588588.075590,
          rho1=1.96495613421e-12, T1=855.719921848, v1=163547.652718)


def make_params(mach=2, n=128, **prob):
    merged = dict(M2 if mach == 2 else M5)
    merged.update(prob)
    p = Params()
    p = p.with_ns("amr", n_cell=(n,))
    p = p.with_ns("geometry", prob_lo=(-1000.0, 0.0, 0.0), prob_hi=(500.0, 1.0, 1.0))
    p = p.with_ns("castro", lo_bc=(2,), hi_bc=(2,), do_hydro=1, do_radiation=1, cfl=0.5,
                  small_temp=1.0, small_dens=1e-20, small_pres=1e-25)
    p = p.with_ns("eos", eos_name="rad_power_law", eos_gamma=1.6666666667)
    # cv = k/((gamma-1) mu m_u), mu = 1: the inputs' ideal gas
    p = p.replace(extra={"eos.const_c_v": 1.2472335702397082e8})
    p = p.with_ns("radiation", ngroups=1, comoving=0, const_kappa_p=3.92663697758e-5,
                  const_kappa_r=0.848902853095, lo_bc=(101, 0, 0), hi_bc=(101, 0, 0),
                  limiter=2, outer_iters=6,
                  # Dirichlet Er = a T^4 of the two equilibrium states
                  lo_bcval=(C.a_rad * merged["T0"] ** 4, 0.0, 0.0),
                  hi_bcval=(C.a_rad * merged["T1"] ** 4, 0.0, 0.0))
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=merged)


def problem_init(sim, u):
    """The pre-shock (x < 0) and post-shock (x > 0) states."""
    pp = sim.params.problem
    x = sim.geom.cell_centers(0, sim.ng).expand(tuple(u.shape[1:]))
    pre = x < 0.0

    def side(a, b):
        return torch.where(pre, torch.full_like(x, a), torch.full_like(x, b))

    return fill_from_prim(sim, u, side(pp["rho0"], pp["rho1"]), (side(pp["v0"], pp["v1"]), 0.0, 0.0),
                          T=side(pp["T0"], pp["T1"]))


def rad_init(sim):
    """Er = a T^4 on each side (each in equilibrium with its gas)."""
    pp = sim.params.problem
    x = sim.geom.cell_centers_1d(0, 0)
    T = torch.where(x < 0.0, torch.full_like(x, pp["T0"]), torch.full_like(x, pp["T1"]))
    return C.a_rad * T ** 4
