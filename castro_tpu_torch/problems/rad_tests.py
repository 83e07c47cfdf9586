"""Radiation test problems (counterpart of `castro_tpu/problems/rad_tests.py`;
reference `Exec/radiation_tests/*`).

- thermal_wave: RadThermalWave, a point thermal explosion diffusing
  through a cold constant-cv medium with kappa_R ~ T^(1/2) (the Zel'dovich
  nonlinear thermal wave; 1D spherical).
- rad_source: RadSourceTest, 0-D matter-radiation relaxation with a
  constant Planck opacity and no diffusion; the cooling and heating cases
  have the exact exponential equilibration of the reference's
  `analytic.f90`.

Both run through the radiation step of `Simulation` (do_hydro=0, gray
FLD), with the defaults of the reference's `inputs.*` files.
"""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.config import Params

# RadThermalWave inputs.1d
TW_DEFAULTS = dict(rhocv=0.05, T0=1e-6, Eexp=3e7, rexp=3.125)


def thermal_wave_params(n=64, prob_hi=200.0, **prob):
    merged = dict(TW_DEFAULTS)
    merged.update(prob)
    p = Params()
    p = p.with_ns("amr", n_cell=(n,))
    p = p.with_ns("geometry", coord_sys=2, prob_lo=(0.0, 0.0, 0.0), prob_hi=(prob_hi, 1.0, 1.0))
    p = p.with_ns("castro", lo_bc=(3,), hi_bc=(2,), do_hydro=0, do_radiation=1, small_temp=0.0,
                  fixed_dt=-1.0)
    p = p.with_ns("eos", eos_name="rad_power_law", eos_gamma=1.4)
    p = p.replace(extra={"eos.const_c_v": merged["rhocv"] / 1.0})
    p = p.with_ns("tpu", dtype="float64")
    p = p.with_ns("radiation", ngroups=1, lo_bc=(102, 0, 0), hi_bc=(102, 0, 0),
                  const_kappa_p=1.0e6, const_kappa_r=1.0e-3, kappa_r_exp_n=-0.5, limiter=0,
                  outer_iters=6)
    return p.replace(problem=merged)


def _static_state(sim, u, rho, e, cv):
    L = sim.layout
    u = u.clone()
    u[L.URHO] = rho
    u[L.UMX] = 0.0
    u[L.UEINT] = rho * e
    u[L.UEDEN] = rho * e
    u[L.UTEMP] = e / cv
    u[L.UFS] = rho
    return u


def thermal_wave_init(sim, u):
    pp = dict(TW_DEFAULTS)
    pp.update(sim.params.problem)
    r = sim.geom.cell_centers(0, sim.ng).expand(tuple(u.shape[1:]))
    rho0 = 1.0
    cv = pp["rhocv"] / rho0
    # Eexp deposited uniformly inside rexp as matter internal energy
    e_in = pp["Eexp"] / (4.0 / 3.0 * np.pi * pp["rexp"] ** 3) / rho0
    e = torch.where(r < pp["rexp"], torch.full_like(r, e_in), torch.full_like(r, cv * pp["T0"]))
    return _static_state(sim, u, rho0, e, cv)


# RadSourceTest inputs-cooling / inputs-heating
RS_DEFAULTS = dict(rho_0=1e-7, rhoe_0=1e9, E_rad=1e12, cv=206586826.34730542, kappa_p=4e-8)


def rad_source_params(n=16, heating=False, **prob):
    merged = dict(RS_DEFAULTS)
    if heating:
        # inputs-heating: cold matter in a hot radiation bath
        merged.update(rhoe_0=1e2, E_rad=1e12)
    merged.update(prob)
    p = Params()
    p = p.with_ns("amr", n_cell=(n,))
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(1.0, 1.0, 1.0))
    p = p.with_ns("castro", lo_bc=(0,), hi_bc=(0,), do_hydro=0, do_radiation=1, small_temp=0.0)
    p = p.with_ns("eos", eos_name="rad_power_law", eos_gamma=1.4)
    p = p.replace(extra={"eos.const_c_v": merged["cv"]})
    p = p.with_ns("tpu", dtype="float64")
    p = p.with_ns("radiation", ngroups=1, lo_bc=(102,), hi_bc=(102,),
                  const_kappa_p=merged["kappa_p"], const_kappa_r=1e-10, limiter=0,
                  outer_iters=8)
    return p.replace(problem=merged)


def rad_source_init(sim, u):
    pp = dict(RS_DEFAULTS)
    pp.update(sim.params.problem)
    rho = pp["rho_0"]
    cv = float(sim.params.extra.get("eos.const_c_v", pp["cv"]))
    return _static_state(sim, u, rho, pp["rhoe_0"] / rho, cv)


def rad_source_Er0(sim):
    pp = dict(RS_DEFAULTS)
    pp.update(sim.params.problem)
    return torch.full(tuple(sim.geom.n_cell), pp["E_rad"], dtype=sim.dtype, device=sim.device)
