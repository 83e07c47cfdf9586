"""celldet, planet and bwp-rad (counterpart of
`castro_tpu/problems/science_extra.py`; reference
`Exec/science/{celldet,planet,bwp-rad}`).

- celldet: a cellular detonation, a hot/cold C/O interface whose position
  is perturbed sinusoidally along y, so that the planar detonation grows
  transverse cells (aprox13, Helmholtz, 2D).
- planet: a hot-Jupiter atmosphere under constant gravity, an isothermal
  gamma-law column with a shear band.
- bwp-rad: a 0.2 Msun solar-like star in 2D RZ with monopole gravity and
  gray FLD radiation (Kramers opacity), through the operator-split
  radiation step (radiation.hydro_coupling=0).
"""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim
from castro_tpu_torch.utils.initial_models import HostEos

CD_DEFAULTS = dict(T_l=1.0e9, T_r=5.0e7, dens_l=1.0e8, dens_r=1.0e8, cfrac=0.5, ofrac=0.0,
                   w_T=5.0e-4, center_T=0.3, pert_amplitude=0.1, vel=0.0)


def celldet_params(n=(256, 64), **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=tuple(n), stop_time=4.0e-7)
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(4.0e5, 1.0e5, 1.0))
    p = p.with_ns("castro", lo_bc=(2, 0, 0), hi_bc=(2, 0, 0), cfl=0.5, do_react=1,
                  small_dens=1e-5, small_temp=1e7, dtnuc_e=0.25)
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="aprox13")
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(CD_DEFAULTS, **prob))


def celldet_init(sim, u):
    """A sigmoid hot/cold interface at center_T Lx, its position perturbed
    by sin(2 2pi y / Ly)."""
    pp = dict(CD_DEFAULTS, **sim.params.problem)
    L, g = sim.layout, sim.geom
    shape = tuple(u.shape[1:])
    x = g.cell_centers(0, sim.ng).expand(shape).to(u.dtype)
    y = g.cell_centers(1, sim.ng).expand(shape).to(u.dtype)
    Lx = g.prob_hi[0] - g.prob_lo[0]
    Ly = g.prob_hi[1] - g.prob_lo[1]
    width = pp["w_T"] * Lx
    c_T = g.prob_lo[0] + pp["center_T"] * Lx * (
        1.0 + pp["pert_amplitude"] * torch.sin(2.0 * np.pi * 2.0 * y / Ly))
    sigma = 1.0 / (1.0 + torch.exp(-(c_T - x) / width))
    rho = pp["dens_l"] + (pp["dens_r"] - pp["dens_l"]) * (1.0 - sigma)
    T = pp["T_l"] + (pp["T_r"] - pp["T_l"]) * (1.0 - sigma)
    vx = pp["vel"] - 2.0 * pp["vel"] * (1.0 - sigma)
    names = sim.network.spec_names
    xn0 = np.zeros(L.nspec)
    xn0[names.index("C12")] = pp["cfrac"]
    xn0[names.index("O16")] = pp["ofrac"]
    xn0[names.index("He4")] = 1.0 - pp["cfrac"] - pp["ofrac"]
    xn = torch.as_tensor(xn0, dtype=u.dtype, device=u.device).reshape(
        (-1,) + (1,) * len(shape)).expand((L.nspec,) + shape)
    return fill_from_prim(sim, u, rho, (vx, 0.0, 0.0), T=T, xn=xn)


PL_DEFAULTS = dict(dens_base=1.0e-2, T_iso=1.0e3, cutoff_density=1e-10, shear_vel_field=1,
                   shear_height_loc=2.7e9, shear_amplitude=3.863080704e5,
                   shear_height_frac=0.05)
PL_G = -1.0e3


def planet_params(n=(64, 256), **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=tuple(n), stop_time=1.0e6)
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(1.227e9, 3.927e9, 1.0))
    p = p.with_ns("castro", lo_bc=(0, 1, 0), hi_bc=(0, 2, 0), cfl=0.5, do_grav=1,
                  small_dens=1e-15, small_temp=1.0)
    p = p.with_ns("gravity", gravity_type="ConstantGrav", const_grav=PL_G)
    p = p.with_ns("eos", eos_gamma=1.4)
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(PL_DEFAULTS, **prob))


def planet_init(sim, u):
    """An isothermal gamma-law atmosphere, scale height p0/(rho0 |g|), with
    a horizontal shear ramp of half-width shear_height_frac of the height,
    saturating at +-shear_amplitude."""
    pp = dict(PL_DEFAULTS, **sim.params.problem)
    g = sim.geom
    shape = tuple(u.shape[1:])
    y = g.cell_centers(1, sim.ng).expand(shape).to(u.dtype)
    p0 = float(HostEos(sim.eos).state(pp["dens_base"], pp["T_iso"], None).p[0])
    H = p0 / (pp["dens_base"] * abs(PL_G))
    rho = torch.clamp(pp["dens_base"] * torch.exp(-(y - g.prob_lo[1]) / H),
                      min=pp["cutoff_density"])
    T = torch.full(shape, pp["T_iso"], dtype=u.dtype, device=u.device)
    vx = torch.zeros_like(T)
    if pp["shear_vel_field"]:
        hband = pp["shear_height_frac"] * (g.prob_hi[1] - g.prob_lo[1])
        vx = pp["shear_amplitude"] * torch.clamp((y - pp["shear_height_loc"]) / hband,
                                                 -1.0, 1.0)
    return fill_from_prim(sim, u, rho, (vx, 0.0, 0.0), T=T)


BWP_DEFAULTS = dict(rho_c=80.0, T_c=7.0e6, rho_ambient=1.0e-8)


def bwp_rad_params(n=(64, 128), **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=tuple(n), stop_time=100.0)
    p = p.with_ns("geometry", coord_sys=1, prob_lo=(0.0, 0.0, 0.0), prob_hi=(2.48e10, 4.96e10, 1.0))
    p = p.with_ns("castro", lo_bc=(3, 2, 0), hi_bc=(2, 2, 0), cfl=0.5, do_grav=1, do_radiation=1,
                  small_dens=1e-10, small_temp=1e2)
    p = p.with_ns("gravity", gravity_type="MonopoleGrav")
    p = p.with_ns("eos", eos_gamma=5.0 / 3.0)
    # the Kramers opacity kappa = 3.8e22 rho^2 T^-3.5 (inputs_2d)
    p = p.with_ns("radiation", ngroups=1, lo_bc=(102, 101, 0), hi_bc=(105, 101, 0),
                  const_kappa_p=3.8e22, kappa_p_exp_m=2.0, kappa_p_exp_n=3.5,
                  const_kappa_r=3.8e22, kappa_r_exp_m=2.0, kappa_r_exp_n=3.5, limiter=2,
                  comoving=0, hydro_coupling=0, outer_iters=6)
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(BWP_DEFAULTS, **prob))


def bwp_rad_init(sim, u):
    """The 0.2 Msun solar-like star: a spherical HSE model (gamma law, T ~
    rho^(2/3) from the centre) mapped by the spherical radius about the
    lower axis origin, standing in for `SolarLike_0.2M.hse.1280`."""
    from castro_tpu_torch.problems.util import model_state
    from castro_tpu_torch.utils.initial_models import hse_spherical

    pp = dict(BWP_DEFAULTS, **sim.params.problem)
    L = sim.layout
    g = sim.geom
    rmax = float(g.prob_hi[1]) * 1.05
    nshell = 1024
    r1 = np.linspace(rmax / (2 * nshell), rmax, nshell)
    xnj = torch.full((L.nspec,), 1.0 / L.nspec, dtype=torch.float64, device=sim.device)

    def T_of_rho(rho):
        return torch.clamp(pp["T_c"] * (torch.clamp(rho, min=1e-12) / pp["rho_c"]) ** (2.0 / 3.0),
                           min=1.0e3)

    model = hse_spherical(sim.eos, r1, pp["rho_c"], pp["T_c"], lambda m: xnj, T_of_rho=T_of_rho,
                          rho_cutoff=pp["rho_ambient"], device=sim.device)
    shape = tuple(u.shape[1:])
    x = g.cell_centers(0, sim.ng).expand(shape).double()
    y = g.cell_centers(1, sim.ng).expand(shape).double()
    yc = 0.5 * (g.prob_lo[1] + g.prob_hi[1])
    rho, T = model_state(sim, u, model, torch.sqrt(x * x + (y - yc) ** 2))
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), T=T)
