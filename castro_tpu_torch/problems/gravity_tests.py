"""Gravity test-problem setups (reference `Exec/gravity_tests/*`;
counterpart of `castro_tpu/problems/gravity_tests.py:22-117`).

- uniform_cube_sphere: the isolated Poisson solve of a uniform sphere
  (problem=1) or cube (problem=2); the sphere's potential is analytic. Its
  parameters set castro.do_hydro=0 (source-only evolution in
  `Simulation`); the tests build a `Gravity` from them.
- evrard_collapse: the Evrard (1988) adiabatic collapse of a cold
  1/r-density gas sphere under self-gravity.

Both use PoissonGrav with multipole boundary conditions.

- StarGrav: a white dwarf held in HSE under MonopoleGrav (the reference
  reads `WD_rhoc_2.e9_M_1.1.hse.2560`; the spherical march builds the
  same structure at its central density).
- hydrostatic_adjust: that star driven out of HSE by a Gaussian heating
  shell for heating_time seconds (`make_hse_adjust_source`).
- hse_convergence_general: a 1D toy_atm helium atmosphere on Helmholtz,
  for measuring how well the hydro holds HSE.
"""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim, model_state, radius_from_origin
from castro_tpu_torch.utils import constants as C

CUBE_DEFAULTS = dict(ambient_dens=1e-8, density=1.0, diameter=1.0, problem=1)


def cube_sphere_params(n=32, **prob):
    merged = dict(CUBE_DEFAULTS)
    merged.update(prob)
    p = Params()
    p = p.with_ns("amr", n_cell=(n, n, n))
    p = p.with_ns("geometry", prob_lo=(-1.6, -1.6, -1.6), prob_hi=(1.6, 1.6, 1.6))
    p = p.with_ns("castro", lo_bc=(2, 2, 2), hi_bc=(2, 2, 2), do_grav=1, do_hydro=0,
                  small_dens=1e-12, small_temp=1e-12)
    p = p.with_ns("gravity", gravity_type="PoissonGrav", max_multipole_order=4)
    p = p.with_ns("eos", eos_gamma=5.0 / 3.0)
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=merged)


def _xyz(sim, shape):
    g = sim.geom
    return [g.cell_centers(d, sim.ng).expand(shape) for d in range(3)]


def cube_sphere_init(sim, u):
    pp = dict(CUBE_DEFAULTS)
    pp.update(sim.params.problem)
    x, y, z = _xyz(sim, u.shape[1:])
    half = 0.5 * pp["diameter"]
    if int(pp["problem"]) == 1:
        inside = x * x + y * y + z * z < half * half
    else:
        inside = (x.abs() < half) & (y.abs() < half) & (z.abs() < half)
    rho = torch.where(inside, torch.full_like(x, pp["density"]),
                      torch.full_like(x, pp["ambient_dens"]))
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), p=1e-6)


def sphere_potential_exact(r, R, rho0):
    """The uniform sphere's potential (negative), interior and exterior."""
    M = 4.0 / 3.0 * np.pi * R**3 * rho0
    G = C.Gconst
    return np.where(r >= R, -G * M / np.maximum(r, 1e-300),
                    -G * M * (3 * R**2 - r**2) / (2 * R**3))


EVRARD_DEFAULTS = dict(sphere_mass=1.0, sphere_radius=9.0e8, ambient_density=1.0e-5)


def evrard_params(n=32, **prob):
    merged = dict(EVRARD_DEFAULTS)
    merged.update(prob)
    L = 1.6e9
    p = Params()
    p = p.with_ns("amr", n_cell=(n, n, n))
    p = p.with_ns("geometry", prob_lo=(-L, -L, -L), prob_hi=(L, L, L))
    p = p.with_ns("castro", lo_bc=(2, 2, 2), hi_bc=(2, 2, 2), do_grav=1, small_dens=1e-12,
                  small_temp=1e-12, small_pres=1e-30, cfl=0.5)
    p = p.with_ns("gravity", gravity_type="PoissonGrav", max_multipole_order=2)
    p = p.with_ns("eos", eos_gamma=5.0 / 3.0)
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=merged)


def evrard_init(sim, u):
    """The Evrard sphere: rho = M/(2 pi R^2 r) inside R, cold (specific
    internal energy 0.05 GM/R); sphere_mass in solar masses."""
    pp = dict(EVRARD_DEFAULTS)
    pp.update(sim.params.problem)
    x, y, z = _xyz(sim, u.shape[1:])
    r = torch.sqrt(x * x + y * y + z * z)
    R = pp["sphere_radius"]
    M = pp["sphere_mass"] * 1.9884e33
    rho_in = M / (2.0 * np.pi * R**2 * torch.clamp(r, min=0.25 * sim.geom.dx[0]))
    rho = torch.where(r < R, rho_in, torch.full_like(r, pp["ambient_density"]))
    e_spec = 0.05 * C.Gconst * M / R
    pres = (sim.params.eos.eos_gamma - 1.0) * rho * e_spec
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), p=pres)


STARGRAV_DEFAULTS = dict(rho_c=2.0e9, T_c=1.0e7, rho_ambient=1.0e-4)


def star_grav_params(n=640, dim=1, **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=(n,) * dim, stop_time=1.0)
    p = p.with_ns("geometry", coord_sys=2 if dim == 1 else (1 if dim == 2 else 0),
                  prob_lo=(0.0,) * 3, prob_hi=(2.5e8,) * 3)
    p = p.with_ns("castro", lo_bc=(3,) * dim, hi_bc=(2,) * dim, cfl=0.9, do_grav=1,
                  do_sponge=1, init_shrink=0.1, change_max=1.05, sponge_upper_density=1e4,
                  sponge_lower_density=1e2, sponge_timescale=1e-3, small_dens=1e-5,
                  small_temp=1e5)
    p = p.with_ns("gravity", gravity_type="MonopoleGrav", drdxfac=2)
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="general_null", spec_names=("C12", "O16", "He4"))
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(STARGRAV_DEFAULTS, **prob))


def star_grav_init(sim, u):
    """The spherical C/O white dwarf (1024 shells to 1.05 x the domain, on
    the simulation's device) interpolated to |x|."""
    from castro_tpu_torch.utils.initial_models import hse_spherical

    pp = dict(STARGRAV_DEFAULTS, **sim.params.problem)
    L = sim.layout
    rmax = float(sim.geom.prob_hi[0]) * 1.05
    nshell = 1024
    r1 = np.linspace(rmax / (2 * nshell), rmax, nshell)
    xn0 = torch.zeros(L.nspec, dtype=torch.float64, device=sim.device)
    xn0[0] = 0.5  # C12
    xn0[1] = 0.5  # O16
    model = hse_spherical(sim.eos, r1, pp["rho_c"], pp["T_c"], lambda m: xn0,
                          rho_cutoff=pp["rho_ambient"], device=sim.device)
    dist = radius_from_origin(sim, tuple(u.shape[1:])).to(u.dtype)
    rho, T, xn = model_state(sim, u, model, dist, L.nspec)
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), T=T, xn=xn)


HSE_ADJ_DEFAULTS = dict(prob_type=1, heating_time=0.5, heating_rad=0.0, heating_peak=1.0e16,
                        heating_sigma=1.0e7, rho_c=2.0e9, T_c=1.0e7)


def hse_adjust_params(n=640, **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=(n,), stop_time=1.0)
    p = p.with_ns("geometry", coord_sys=2, prob_lo=(0.0,) * 3, prob_hi=(5.0e8, 1.0, 1.0))
    p = p.with_ns("castro", lo_bc=(3,), hi_bc=(2,), cfl=0.9, do_grav=1, add_ext_src=1,
                  init_shrink=0.1, change_max=1.05, small_temp=5e6, small_dens=1e-5)
    p = p.with_ns("gravity", gravity_type="MonopoleGrav")
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="general_null", spec_names=("C12", "O16", "He4"))
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(HSE_ADJ_DEFAULTS, **prob))


hse_adjust_init = star_grav_init  # the same spherical star


def make_hse_adjust_source(params):
    """The Gaussian shell heating H0 exp(-(r - r0)^2 / W^2) into UEINT and
    UEDEN, off after heating_time (`problem_source.H:36-54`); prob_type 3
    weights it by X(He4)."""
    pp = dict(HSE_ADJ_DEFAULTS, **params.problem)
    H0, W0 = pp["heating_peak"], pp["heating_sigma"]
    r0, t_stop = pp["heating_rad"], pp["heating_time"]
    ihe = 2 if pp["prob_type"] == 3 else None

    def ext_src(sim, u, q, qaux, t, dt, ctx=None):
        g = ctx.geom if ctx is not None else sim.geom
        L = sim.layout
        shape = tuple(u.shape[1:])
        axes = [g.cell_centers(d, sim.ng).expand(shape).to(u.dtype) for d in range(L.dim)]
        dist = axes[0] if L.dim == 1 else torch.sqrt(sum(a * a for a in axes))
        Hext = H0 * torch.exp(-((dist - r0) ** 2) / (W0 * W0))
        if ihe is not None:
            Hext = Hext * u[L.UFS + ihe] / torch.clamp(u[L.URHO], min=1e-30)
        rhoH = torch.where(torch.as_tensor(t > t_stop, device=u.device),
                           torch.zeros_like(Hext), u[L.URHO] * Hext)
        src = torch.zeros_like(u)
        src[L.UEINT] = rhoH
        src[L.UEDEN] = rhoH
        return src

    ext_src.name = "problem_source"
    return ext_src


HSE_GEN_DEFAULTS = dict(dens_base=2.0e6, T_star=1.0e8, T_hi=5.0e8, T_lo=5.0e7, H_star=500.0,
                        atm_delta=25.0)
HSE_GEN_G = -2.45e14


def hse_general_params(n=256, **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=(n,), stop_time=1e-4)
    p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(3.2e3, 1.0, 1.0))
    p = p.with_ns("castro", lo_bc=(1,), hi_bc=(2,), cfl=0.8, do_grav=1, small_temp=1e6,
                  small_dens=1e-5)
    p = p.with_ns("gravity", gravity_type="ConstantGrav", const_grav=HSE_GEN_G)
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="general_null", spec_names=("C12", "O16", "He4"))
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(HSE_GEN_DEFAULTS, **prob))


def hse_general_init(sim, u):
    """The toy_atm helium layer over an inert C12 substrate, in x."""
    from castro_tpu_torch.utils.initial_models import model_to_grid, toy_atm

    pp = dict(HSE_GEN_DEFAULTS, **sim.params.problem)
    L = sim.layout
    x1 = sim.geom.cell_centers_1d(0, sim.ng).double().cpu().numpy()
    xn_star = np.zeros(L.nspec)
    xn_star[0] = 1.0
    xn_base = np.zeros(L.nspec)
    xn_base[2] = 1.0
    model = toy_atm(sim.eos, x1, pp["dens_base"], pp["T_star"], pp["T_hi"], pp["T_lo"],
                    pp["H_star"], pp["atm_delta"], xn_star, xn_base, HSE_GEN_G)
    vals = model_to_grid(model, x1)

    def col(v):
        return torch.as_tensor(v, dtype=u.dtype, device=u.device)

    xn = torch.stack([col(vals[f"spec_{k}"]) for k in range(L.nspec)])
    return fill_from_prim(sim, u, col(vals["density"]), (0.0, 0.0, 0.0),
                          T=col(vals["temperature"]), xn=xn)
