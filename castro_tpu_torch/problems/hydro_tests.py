"""Hydro test-problem setups (counterpart of
`castro_tpu/problems/hydro_tests.py`; reference `Exec/hydro_tests/*`).

KH (Kelvin-Helmholtz, problem variants 1/2), RT (Rayleigh-Taylor under
ConstantGrav), Noh (the spherical/cylindrical implosion, with its exact
post-shock density), gresho_vortex (a rotating equilibrium, Miczek et al.
2015), oddeven (the grid-aligned carbuncle perturbation, run with
hybrid_riemann), rotating_torus (a Papaloizou-Pringle torus about a point
mass, with PoissonGrav and hybrid_hydro) and Vortices_LWAcoustics. The
initial conditions are the reference's `problem_initialize_state_data.H`
with the `_prob_params` defaults; overrides go through `problem.*`. Each
setup is a `*_params` / `*_init` pair for `Simulation(params,
problem_init=...)`; the CLI registers none of them, as the JAX CLI does
not.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim


def _base(n_cell, prob_lo, prob_hi, lo_bc, hi_bc, gamma=1.4, dtype="float64", **prob):
    dim = len(n_cell)
    p = Params()
    p = p.with_ns("amr", n_cell=tuple(n_cell))
    p = p.with_ns("geometry", prob_lo=tuple(prob_lo) + (0.0,) * (3 - dim),
                  prob_hi=tuple(prob_hi) + (1.0,) * (3 - dim))
    p = p.with_ns("castro", lo_bc=tuple(lo_bc) + (0,) * (3 - dim),
                  hi_bc=tuple(hi_bc) + (0,) * (3 - dim), cfl=0.5,
                  small_dens=1e-12, small_temp=1e-12, small_pres=1e-15)
    p = p.with_ns("eos", eos_gamma=gamma)
    p = p.with_ns("tpu", dtype=dtype)
    return p.replace(problem=dict(prob))


def _xy(sim, u):
    shape = tuple(u.shape[1:])
    x = sim.geom.cell_centers(0, sim.ng).expand(shape)
    y = sim.geom.cell_centers(1, sim.ng).expand(shape)
    return x, y, shape


def _full(v, like):
    return torch.full_like(like, v)


# ---------------------------------------------------------------------------
# Kelvin-Helmholtz (Exec/hydro_tests/KH)

KH_DEFAULTS = dict(rho1=1.0, rho2=2.0, pressure=2.5, problem=2, bulk_velocity=0.0)


def kh_params(n=64, **prob):
    merged = dict(KH_DEFAULTS)
    merged.update(prob)
    return _base((n, n), (0.0, 0.0), (1.0, 1.0), (0, 0), (0, 0), gamma=5.0 / 3.0, **merged)


def kh_init(sim, u):
    pp = dict(KH_DEFAULTS)
    pp.update(sim.params.problem)
    x, y, shape = _xy(sim, u)
    g = sim.geom
    yc = 0.5 * (g.prob_lo[1] + g.prob_hi[1])
    Ly = g.prob_hi[1] - g.prob_lo[1]
    y1 = yc - 0.25 * Ly
    y2 = yc + 0.25 * Ly
    if int(pp["problem"]) == 1:
        sine_n, w0, sigma = 4, 0.1, 0.05 / np.sqrt(2.0)
        mid = torch.abs(y - 0.5 * (y1 + y2)) < 0.5 * (y2 - y1)
        rho = torch.where(mid, _full(pp["rho2"], y), _full(pp["rho1"], y))
        vx = torch.where(mid, _full(0.5, y), _full(-0.5, y))
        vy = w0 * torch.sin(sine_n * math.pi * x) * (
            torch.exp(-((y - y1) ** 2) / (2 * sigma ** 2))
            + torch.exp(-((y - y2) ** 2) / (2 * sigma ** 2)))
    else:  # problem 2 (smooth ramp)
        sine_n, w0, dy = 2, 0.1, 0.05
        ramp = 1.0 / ((1.0 + torch.exp(-2.0 * (y - y1) / dy))
                      * (1.0 + torch.exp(2.0 * (y - y2) / dy)))
        rho = pp["rho1"] + ramp * (pp["rho2"] - pp["rho1"])
        vx = -0.5 + ramp * 1.0
        vy = w0 * torch.sin(sine_n * math.pi * x)
    vx = vx + pp["bulk_velocity"]
    return fill_from_prim(sim, u, rho, (vx, vy, 0.0), p=pp["pressure"])


# ---------------------------------------------------------------------------
# Rayleigh-Taylor (Exec/hydro_tests/RT)

RT_DEFAULTS = dict(rho_1=1.0, rho_2=2.0, p0_base=5.0, L_x=0.5, g=-1.0)


def rt_params(n=(64, 128), **prob):
    merged = dict(RT_DEFAULTS)
    merged.update(prob)
    p = _base(tuple(n), (0.0, 0.0), (merged["L_x"], 1.0), (0, 4), (0, 4), gamma=1.4, **merged)
    p = p.with_ns("castro", do_grav=1)
    return p.with_ns("gravity", gravity_type="ConstantGrav", const_grav=merged["g"])


def rt_init(sim, u):
    pp = dict(RT_DEFAULTS)
    pp.update(sim.params.problem)
    x, y, shape = _xy(sim, u)
    Lx = pp["L_x"]
    split = 0.5
    presmid = pp["p0_base"] - pp["rho_1"] * split
    pres = torch.where(y < split, pp["p0_base"] - pp["rho_1"] * y,
                       presmid - pp["rho_2"] * (y - split))
    perth = 0.01 * 0.5 * (torch.cos(2 * math.pi * x / Lx)
                          + torch.cos(2 * math.pi * (Lx - x) / Lx)) + 0.5
    rho = pp["rho_1"] + 0.5 * (pp["rho_2"] - pp["rho_1"]) * (
        1.0 + torch.tanh((y - perth) / 0.005))
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), p=pres)


# ---------------------------------------------------------------------------
# Noh implosion (Exec/hydro_tests/Noh): uniform inward |v| = 1, p ~ 0; the
# exact solution is an outward shock at r = t/3 with rho = 16 (2D) or 64
# (3D or 1D spherical) for gamma = 5/3

NOH_DEFAULTS = dict(rho0=1.0, p0=1e-6, vel=1.0)


def noh_params(n=64, dim=2, coord=0, **prob):
    merged = dict(NOH_DEFAULTS)
    merged.update(prob)
    # an octant with symmetry at the low faces, outflow at the high ones
    p = _base((n,) * dim, (0.0,) * dim, (1.0,) * dim, (3,) * dim, (2,) * dim,
              gamma=5.0 / 3.0, **merged)
    if coord:
        p = p.with_ns("geometry", coord_sys=coord)
    return p


def noh_init(sim, u):
    pp = dict(NOH_DEFAULTS)
    pp.update(sim.params.problem)
    g = sim.geom
    shape = tuple(u.shape[1:])
    coords = [g.cell_centers(d, sim.ng).expand(shape) for d in range(g.dim)]
    r = torch.sqrt(sum(c * c for c in coords))
    rsafe = torch.clamp(r, min=1e-10)
    vel = [-pp["vel"] * c / rsafe for c in coords] + [0.0] * (3 - g.dim)
    return fill_from_prim(sim, u, pp["rho0"], tuple(vel), p=pp["p0"])


def noh_postshock_density(gamma=5.0 / 3.0, dim=2):
    """The exact stagnated density: rho0 ((g+1)/(g-1))^dim."""
    return ((gamma + 1.0) / (gamma - 1.0)) ** dim


# ---------------------------------------------------------------------------
# Gresho vortex (Exec/hydro_tests/gresho_vortex; Miczek et al. 2015)

GRESHO_DEFAULTS = dict(p0=1.0, rho0=1.0, t_r=1.0)


def gresho_params(n=64, **prob):
    merged = dict(GRESHO_DEFAULTS)
    merged.update(prob)
    return _base((n, n), (-0.5, -0.5), (0.5, 0.5), (0, 0), (0, 0), gamma=1.4, **merged)


def gresho_profiles(r, p0):
    """(u_phi, p) of the stationary vortex."""
    zero = torch.zeros_like(r)
    u = torch.where(r < 0.2, 5.0 * r, torch.where(r < 0.4, 2.0 - 5.0 * r, zero))
    p = torch.where(
        r < 0.2, p0 + 12.5 * r * r,
        torch.where(r < 0.4,
                    p0 + 12.5 * r * r + 4.0 * (1.0 - 5.0 * r - math.log(0.2) + torch.log(r)),
                    _full(p0 - 2.0 + 4.0 * math.log(2.0), r)))
    return u, p


def gresho_init(sim, u):
    pp = dict(GRESHO_DEFAULTS)
    pp.update(sim.params.problem)
    x, y, shape = _xy(sim, u)
    r = torch.sqrt(x * x + y * y)
    rsafe = torch.clamp(r, min=1e-10)
    uphi, p = gresho_profiles(r, pp["p0"])
    vx = -uphi * y / rsafe
    vy = uphi * x / rsafe
    return fill_from_prim(sim, u, pp["rho0"], (vx, vy, 0.0), p=p)


# ---------------------------------------------------------------------------
# odd-even (carbuncle) perturbation (Exec/hydro_tests/oddeven): a strong
# grid-aligned shock seeded with a single-column density perturbation, run
# with castro.hybrid_riemann=1 to suppress the instability

ODDEVEN_DEFAULTS = dict(p_ambient=1.0, dens_ambient=1.0, dens_pert_factor=1.01, vel_pert=20.0)


def oddeven_params(n=64, **prob):
    merged = dict(ODDEVEN_DEFAULTS)
    merged.update(prob)
    p = _base((n, n), (0.0, 0.0), (1.0, 1.0), (2, 2), (2, 2), gamma=1.4, **merged)
    return p.with_ns("castro", hybrid_riemann=1, use_shock_var=0)


def oddeven_init(sim, u):
    pp = dict(ODDEVEN_DEFAULTS)
    pp.update(sim.params.problem)
    x, y, shape = _xy(sim, u)
    g = sim.geom
    dx = g.dx[0]
    xc = 0.5 * (g.prob_lo[0] + g.prob_hi[0])
    # the single-column density perturbation at the midplane
    pert_col = torch.abs(x - xc) < 0.5 * dx
    rho = torch.where(pert_col, _full(pp["dens_ambient"] * pp["dens_pert_factor"], x),
                      _full(pp["dens_ambient"], x))
    vx = torch.where(x < xc, _full(pp["vel_pert"], x), _full(-pp["vel_pert"], x))
    return fill_from_prim(sim, u, rho, (vx, 0.0, 0.0), p=pp["p_ambient"])


# ---------------------------------------------------------------------------
# rotating torus (Exec/hydro_tests/rotating_torus): a Papaloizou-Pringle
# torus in Keplerian rotation about a point mass; the hybrid-momentum
# showcase (angular momentum conserved over many orbits)

TORUS_DEFAULTS = dict(inner_radius=0.75, outer_radius=1.5, ambient_density=1e-8,
                      point_mass=1.0)


def rotating_torus_params(n=(48, 48, 24), **prob):
    merged = dict(TORUS_DEFAULTS)
    merged.update(prob)
    p = _base(tuple(n), (-2.0, -2.0, -1.0), (2.0, 2.0, 1.0), (2, 2, 2), (2, 2, 2),
              gamma=5.0 / 3.0, **merged)
    p = p.with_ns("castro", do_grav=1, hybrid_momentum=1, hybrid_hydro=1, use_point_mass=1,
                  point_mass=merged["point_mass"])
    return p.with_ns("gravity", gravity_type="PoissonGrav", max_multipole_order=2)


def rotating_torus_init(sim, u):
    """The polytropic Papaloizou-Pringle torus: the potential psi = -GM/r +
    l^2/(2 R^2) has its minimum on the density-maximum ring; the enthalpy
    h = psi_edge - psi is positive inside the torus."""
    pp = dict(TORUS_DEFAULTS)
    pp.update(sim.params.problem)
    g = sim.geom
    shape = tuple(u.shape[1:])
    x, y, z = (g.cell_centers(d, sim.ng).expand(shape) for d in range(3))
    GM = pp["point_mass"]
    r_in = pp["inner_radius"]
    r_out = pp["outer_radius"]
    R = torch.sqrt(x * x + y * y)
    r = torch.sqrt(R * R + z * z)
    # the density-maximum radius and the specific angular momentum
    r_max = 2.0 * r_in * r_out / (r_in + r_out)
    ell2 = GM * r_max
    rsafe = torch.clamp(r, min=1e-10)
    Rsafe = torch.clamp(R, min=1e-10)
    psi = -GM / rsafe + ell2 / (2.0 * Rsafe ** 2)
    psi_edge = -GM / r_in + ell2 / (2.0 * r_in ** 2)
    gamma = sim.params.eos.eos_gamma
    K = 1.0
    h = torch.clamp(psi_edge - psi, min=0.0)
    rho = (h * (gamma - 1.0) / (gamma * K)) ** (1.0 / (gamma - 1.0))
    rho = torch.clamp(rho, min=pp["ambient_density"])
    pres = K * rho ** gamma
    vphi = math.sqrt(ell2) / Rsafe
    inside = rho > 2.0 * pp["ambient_density"]
    zero = torch.zeros_like(rho)
    vx = torch.where(inside, -vphi * y / Rsafe, zero)
    vy = torch.where(inside, vphi * x / Rsafe, zero)
    return fill_from_prim(sim, u, rho, (vx, vy, 0.0), p=pres)


# ---------------------------------------------------------------------------
# Vortices_LWAcoustics (Exec/hydro_tests/Vortices_LWAcoustics): sound
# generation by a co-rotating vortex pair (the Lee & Koo 1995 benchmark)

LWA_DEFAULTS = dict(p_ref=1.0, r_0=0.25, mach=0.07960, ratio_c=0.15, r_circ=1.0)


def lw_acoustics_params(n=128, **prob):
    merged = dict(LWA_DEFAULTS)
    merged.update(prob)
    return _base((n, n), (0.0, 0.0), (50.0, 50.0), (2, 2), (2, 2), gamma=1.4, **merged)


def lw_acoustics_init(sim, u):
    """Two co-rotating point vortices with algebraically regularized cores,
    2 r_0 apart about the domain's centre, on the isentropic background
    rho_0 = p_ref^(1/gamma) (`problem_initialize.H:16-38`,
    `problem_initialize_state_data.H`)."""
    pp = dict(LWA_DEFAULTS)
    pp.update(sim.params.problem)
    gamma = sim.params.eos.eos_gamma
    x, y, shape = _xy(sim, u)
    hi = sim.params.geometry.prob_hi

    rho0 = pp["p_ref"] ** (1.0 / gamma)
    c0 = np.sqrt(gamma * pp["p_ref"] / rho0)
    r_c = pp["ratio_c"] * pp["r_0"]
    circ = pp["r_circ"] * pp["r_0"] * c0
    xc, yc = 0.5 * hi[0], 0.5 * hi[1]
    centers = ((xc, yc + pp["r_0"]), (xc, yc - pp["r_0"]))

    vx = torch.zeros(shape, dtype=u.dtype, device=u.device)
    vy = torch.zeros(shape, dtype=u.dtype, device=u.device)
    for cx, cy in centers:
        r = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2)
        vth = circ * r / (2.0 * np.pi * (r_c * r_c + r * r))
        rs = torch.clamp(r, min=1e-300)
        vx = vx + vth * (y - cy) / rs
        vy = vy - vth * (x - cx) / rs

    rho = torch.full(shape, rho0, dtype=u.dtype, device=u.device)
    pres = torch.full(shape, pp["p_ref"], dtype=u.dtype, device=u.device)
    return fill_from_prim(sim, u, rho, (vx, vy, 0.0), p=pres)
