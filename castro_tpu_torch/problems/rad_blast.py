"""RadBlastWave (counterpart of `castro_tpu/problems/rad_blast.py`; reference
`Exec/radiation_tests/RadBlastWave`): a radiation-dominated point
explosion, a hot sphere (T1 = 1e7 K) in a cold (T0 = 1e3 K) thin medium,
evolved with gray FLD rad-hydro in 1D spherical symmetry through the
operator-split step (radiation.hydro_coupling=0). The initial data follow
`problem_initialize_state_data.H:30-110` (the subzone-averaged T^4 mixing
at the sphere's edge, here a smooth ramp over one cell width) with the
inputs.1d opacities (kappa_p = 2e-16, kappa_r = 2e-10, LP limiter)."""

from __future__ import annotations

import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim
from castro_tpu_torch.utils import constants as C

DEFAULTS = dict(rho0=5.0e-6, T0=1.0e3, rho1=5.0e-6, T1=1.0e7, r1=0.02)


def make_params(n=128, **prob):
    merged = dict(DEFAULTS)
    merged.update(prob)
    p = Params()
    p = p.with_ns("amr", n_cell=(n,), stop_time=1.0e6)
    p = p.with_ns("geometry", coord_sys=2, prob_lo=(0.0,) * 3, prob_hi=(1.0e14, 1.0, 1.0))
    p = p.with_ns("castro", lo_bc=(3,), hi_bc=(2,), cfl=0.6, do_radiation=1, init_shrink=0.01,
                  change_max=1.05, small_dens=1e-30, small_temp=1.0)
    p = p.with_ns("eos", eos_name="rad_power_law", eos_gamma=5.0 / 3.0)
    # the ideal-gas cv (mu = 1) of the reference's gamma-law radiation EOS
    cv = C.k_B / (C.m_u * (5.0 / 3.0 - 1.0))
    p = p.replace(extra={"eos.const_c_v": cv})
    p = p.with_ns("radiation", ngroups=1, lo_bc=(102,), hi_bc=(102,), const_kappa_p=2.0e-16,
                  const_kappa_r=2.0e-10, limiter=2, outer_iters=6, hydro_coupling=0)
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=merged)


def problem_init(sim, u):
    pp = dict(DEFAULTS)
    pp.update(sim.params.problem)
    g = sim.geom
    r = g.cell_centers(0, sim.ng).expand(tuple(u.shape[1:]))
    r_init = pp["r1"] * g.prob_hi[0]
    w = 0.5 * g.dx[0]
    inside = 0.5 * (1.0 - torch.tanh((r - r_init) / w))
    # the T^4-volume-weighted mixing at the interface
    T4 = inside * pp["T1"] ** 4 + (1.0 - inside) * pp["T0"] ** 4
    rho = inside * pp["rho1"] + (1.0 - inside) * pp["rho0"]
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), T=T4 ** 0.25)
