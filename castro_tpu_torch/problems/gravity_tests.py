"""Gravity test-problem setups (reference `Exec/gravity_tests/*`;
counterpart of `castro_tpu/problems/gravity_tests.py:22-117`).

- uniform_cube_sphere: the isolated Poisson solve of a uniform sphere
  (problem=1) or cube (problem=2); the sphere's potential is analytic. Its
  parameters set castro.do_hydro=0, which the port's Simulation does not
  take yet (ROADMAP.md, queue 1 item 10): build a `Gravity` from them.
- evrard_collapse: the Evrard (1988) adiabatic collapse of a cold
  1/r-density gas sphere under self-gravity.

Both use PoissonGrav with multipole boundary conditions. StarGrav,
hydrostatic_adjust and hse_convergence_general
(`castro_tpu/problems/gravity_tests.py:112-290`) are not ported yet
(ROADMAP.md, queue 1 item 7, the remaining setups).
"""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim
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
