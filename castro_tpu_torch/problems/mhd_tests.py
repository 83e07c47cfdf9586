"""MHD test setups (reference `Exec/mhd_tests/*`; counterpart of
`castro_tpu/problems/mhd_tests.py`).

BrioWu, DaiWoodward, FastRarefaction (Riemann tubes), Alfven (the
circularly polarized wave), MagnetosonicWaves (fast and slow eigenmodes),
LoopAdvection (a field loop from a vector potential: div B = 0 initial data
by construction), RT (magnetized Rayleigh-Taylor) and species (passive
advection). Each takes the reference's `_prob_params` defaults and
`problem_initialize_*` data; overrides go through the `problem.*`
namespace. The inits take an MhdSimulation, a Simulation with
castro.do_mhd=1, or an AMR window's view of one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim


def _base_params(n_cell, prob_lo, prob_hi, lo_bc, hi_bc, gamma, **prob):
    p = Params()
    dim = len(n_cell)
    p = p.with_ns("amr", n_cell=tuple(n_cell))
    p = p.with_ns("geometry", prob_lo=tuple(prob_lo) + (0.0,) * (3 - dim),
                  prob_hi=tuple(prob_hi) + (1.0,) * (3 - dim))
    p = p.with_ns("castro", lo_bc=tuple(lo_bc) + (0,) * (3 - dim),
                  hi_bc=tuple(hi_bc) + (0,) * (3 - dim), cfl=0.4, do_mhd=1,
                  small_dens=1e-12, small_temp=1e-12, small_pres=1e-15)
    p = p.with_ns("eos", eos_gamma=gamma)
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(prob))


def _base(sim):
    """The Simulation of an MhdSimulation, else the sim itself."""
    return getattr(sim, "base", sim)


def _pp(sim, defaults):
    pp = dict(defaults)
    pp.update(_base(sim).params.problem)
    return pp


def _full(shape, value, like):
    return torch.full(tuple(shape), float(value), dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Riemann shock tubes (BrioWu, DaiWoodward, FastRarefaction)

_TUBE_DEFAULTS = dict(
    rho_l=1.0, u_l_x=0.0, u_l_y=0.0, u_l_z=0.0, p_l=1.0,
    B_x_l=0.75, B_y_l=1.0, B_z_l=0.0,
    rho_r=0.125, u_r_x=0.0, u_r_y=0.0, u_r_z=0.0, p_r=0.1,
    B_x_r=0.75, B_y_r=-1.0, B_z_r=0.0, frac=0.5)

# problem.* values from the reference inputs files
DAI_WOODWARD = dict(_TUBE_DEFAULTS, p_l=0.95, u_l_x=1.2, u_l_y=0.01,
                    u_l_z=0.5, rho_l=1.08,
                    B_x_l=0.5641895835477563, B_y_l=1.0155412503859613,
                    B_z_l=0.5641895835477563,
                    p_r=1.0, rho_r=1.0,
                    B_x_r=0.5641895835477563, B_y_r=1.1283791670955126,
                    B_z_r=0.5641895835477563)
FAST_RAREFACTION = dict(_TUBE_DEFAULTS, p_l=0.45, u_l_x=-2.0, rho_l=1.0,
                        B_x_l=0.0, B_y_l=0.5, B_z_l=0.0,
                        p_r=0.45, u_r_x=2.0, rho_r=1.0,
                        B_x_r=0.0, B_y_r=0.5, B_z_r=0.0)


def tube_params(n=512, gamma=2.0, defaults=None, **prob):
    merged = dict(defaults or _TUBE_DEFAULTS)
    merged.update(prob)
    return _base_params((n,), (0.0,), (1.0,), (2,), (2,), gamma, **merged)


def tube_init(defaults=None):
    base_pp = dict(defaults or _TUBE_DEFAULTS)

    def init(msim, u, b):
        sim = _base(msim)
        pp = dict(base_pp)
        pp.update(sim.params.problem)
        x = sim.geom.cell_centers(0, sim.ng)
        shape = u.shape[1:]
        left = x.expand(shape) < pp["frac"]

        def pick(a, bb):
            return torch.where(left, _full(shape, a, u), _full(shape, bb, u))

        rho = pick(pp["rho_l"], pp["rho_r"])
        vel = tuple(pick(pp[f"u_l_{c}"], pp[f"u_r_{c}"]) for c in "xyz")
        p = pick(pp["p_l"], pp["p_r"])
        u = fill_from_prim(sim, u, rho, vel, p=p)
        return u, tuple(pick(pp[f"B_{c}_l"], pp[f"B_{c}_r"]) for c in "xyz")

    return init


def brio_wu_params(n=512, **prob):
    return tube_params(n=n, gamma=2.0, **prob)


def dai_woodward_params(n=256, **prob):
    return tube_params(n=n, gamma=5.0 / 3.0, defaults=DAI_WOODWARD, **prob)


def fast_rarefaction_params(n=256, **prob):
    return tube_params(n=n, gamma=1.4, defaults=FAST_RAREFACTION, **prob)


# ---------------------------------------------------------------------------
# Alfven wave (Exec/mhd_tests/Alfven)

ALFVEN_DEFAULTS = dict(rho_0=1.0, p_0=0.1, B_0=1.0, amp=1e-3, k_x=1.0)


def alfven_params(n=32, dim=3, **prob):
    merged = dict(ALFVEN_DEFAULTS)
    merged.update(prob)
    return _base_params((n,) * dim, (0.0,) * dim, (1.0,) * dim, (0,) * dim, (0,) * dim,
                        5.0 / 3.0, **merged)


def alfven_init(msim, u, b):
    pp = _pp(msim, ALFVEN_DEFAULTS)
    sim = _base(msim)
    rho0, p0, B0, amp = pp["rho_0"], pp["p_0"], pp["B_0"], pp["amp"]
    vA = B0 / np.sqrt(rho0)
    shape = u.shape[1:]
    X = sim.geom.cell_centers(0, sim.ng).expand(shape)
    kx = 2 * math.pi * pp["k_x"]
    vy = amp * torch.sin(kx * X)
    vz = amp * torch.cos(kx * X)
    u = fill_from_prim(sim, u, rho0, (0.0, vy, vz), p=p0)
    bx = _full(shape, B0, u)
    by = -amp * B0 * torch.sin(kx * X) / vA
    bz = -amp * B0 * torch.cos(kx * X) / vA
    return u, (bx, by, bz)


# ---------------------------------------------------------------------------
# magnetosonic waves (Exec/mhd_tests/MagnetosonicWaves): fast or slow
# eigenmode perturbations of a uniform field along x

MS_DEFAULTS = dict(rho_0=1.0, p_0=1.0, B_0=1.0, amp=1e-5, type_wave=1, k_x=1.0, k_y=1.0)


def magnetosonic_params(n=64, **prob):
    merged = dict(MS_DEFAULTS)
    merged.update(prob)
    return _base_params((n, n), (0.0, 0.0), (1.0, 1.0), (0, 0), (0, 0), 5.0 / 3.0, **merged)


def magnetosonic_init(msim, u, b):
    """The fast (type_wave=1) or slow (2) eigenmode with k in the x-y plane
    and B along x, its phase speed from the dispersion relation."""
    pp = _pp(msim, MS_DEFAULTS)
    sim = _base(msim)
    gamma = sim.params.eos.eos_gamma
    rho0, p0, B0, amp = pp["rho_0"], pp["p_0"], pp["B_0"], pp["amp"]
    a2 = gamma * p0 / rho0
    ca2 = B0 * B0 / rho0

    shape = u.shape[1:]
    kx = 2 * math.pi * pp["k_x"]
    ky = 2 * math.pi * pp["k_y"]
    X = sim.geom.cell_centers(0, sim.ng).expand(shape)
    Y = sim.geom.cell_centers(1, sim.ng).expand(shape)
    phase = kx * X + ky * Y
    k = np.sqrt(float(kx) ** 2 + float(ky) ** 2)
    cosb = float(kx) / k  # the angle between k and B (B along x)
    cad2 = ca2 * cosb * cosb
    disc = np.sqrt(max((a2 + ca2) ** 2 - 4 * a2 * cad2, 0.0))
    cf2 = 0.5 * ((a2 + ca2) + disc)
    cs2 = 0.5 * ((a2 + ca2) - disc)
    c2 = cf2 if int(pp["type_wave"]) == 1 else cs2
    c = np.sqrt(c2)

    # the eigenmode's amplitudes (Stone et al.'s linear-wave convention)
    drho = amp * torch.cos(phase)
    rho = rho0 + drho
    vk = c * drho / rho0  # the velocity along k
    vx = vk * cosb
    vy = vk * float(ky) / k
    p = p0 + c2 * drho
    u = fill_from_prim(sim, u, rho, (vx, vy, 0.0), p=p)
    # the transverse B perturbation (div B = 0 for the k.B' = 0 mode)
    dB = amp * B0 * torch.cos(phase)
    bx = _full(shape, B0, u) + dB * (float(ky) / k) ** 2
    by = -dB * cosb * float(ky) / k * torch.ones(shape, dtype=u.dtype, device=u.device)
    bz = torch.zeros(shape, dtype=u.dtype, device=u.device)
    return u, (bx, by, bz)


# ---------------------------------------------------------------------------
# field-loop advection (Exec/mhd_tests/LoopAdvection): B from a vector
# potential A_z on the edges, so the face B is divergence-free to round-off

LOOP_DEFAULTS = dict(rho_0=1.0, rhoe_0=1.0, u_x=2.0, u_y=1.0, B_0=1e-3, r_loop=0.3)


def loop_advection_params(n=64, **prob):
    merged = dict(LOOP_DEFAULTS)
    merged.update(prob)
    return _base_params((n, n), (-0.5, -0.5), (0.5, 0.5), (0, 0), (0, 0), 5.0 / 3.0, **merged)


def loop_advection_init(msim, u, b):
    pp = _pp(msim, LOOP_DEFAULTS)
    sim = _base(msim)
    g = sim.geom
    ng = sim.ng
    shape = u.shape[1:]
    gamma = sim.params.eos.eos_gamma
    p0 = pp["rhoe_0"] * (gamma - 1.0)
    u = fill_from_prim(sim, u, pp["rho_0"], (pp["u_x"], pp["u_y"], 0.0), p=p0)

    # A_z at the nodes (i-1/2, j-1/2), stored at (i, j)
    dx, dy = float(g.dx[0]), float(g.dx[1])
    nx, ny = shape
    xe = g.prob_lo[0] + (np.arange(nx + 1) - ng) * dx
    ye = g.prob_lo[1] + (np.arange(ny + 1) - ng) * dy
    XE, YE = np.meshgrid(xe, ye, indexing="ij")
    r = np.sqrt(XE ** 2 + YE ** 2)
    A = np.where(r <= pp["r_loop"], pp["B_0"] * (pp["r_loop"] - r), 0.0)

    def t_(a):
        return torch.as_tensor(a, dtype=u.dtype, device=u.device)

    # Bx_{i-1/2,j} = (A_z_{i-1/2,j+1/2} - A_z_{i-1/2,j-1/2}) / dy
    bx = t_((A[:-1, 1:] - A[:-1, :-1]) / dy)
    by = t_(-(A[1:, :-1] - A[:-1, :-1]) / dx)
    return u, (bx, by, torch.zeros(shape, dtype=u.dtype, device=u.device))


# ---------------------------------------------------------------------------
# magnetized Rayleigh-Taylor (Exec/mhd_tests/RT)

RT_DEFAULTS = dict(rho_1=1.0, rho_2=2.0, p0_base=5.0, L_x=0.5, B_0=0.0, frac=0.5, g=-1.0,
                   amp=0.01)


def rt_params(n=(64, 128), **prob):
    merged = dict(RT_DEFAULTS)
    merged.update(prob)
    p = _base_params(tuple(n), (0.0, 0.0), (0.5, 1.0), (0, 4), (0, 4), 5.0 / 3.0, **merged)
    p = p.with_ns("gravity", gravity_type="ConstantGrav", const_grav=merged["g"])
    return p.with_ns("castro", do_grav=1)


def rt_init(msim, u, b):
    pp = _pp(msim, RT_DEFAULTS)
    sim = _base(msim)
    g = sim.geom
    shape = u.shape[1:]
    x = g.cell_centers(0, sim.ng).expand(shape)
    y = g.cell_centers(1, sim.ng).expand(shape)
    y_if = pp["frac"] * (g.prob_lo[1] + g.prob_hi[1])
    below = y < y_if
    rho = torch.where(below, _full(shape, pp["rho_1"], u), _full(shape, pp["rho_2"], u))
    # the HSE pressure about the interface
    p = pp["p0_base"] + pp["g"] * torch.where(
        below, pp["rho_1"] * (y - g.prob_lo[1]),
        pp["rho_1"] * (y_if - g.prob_lo[1]) + pp["rho_2"] * (y - y_if))
    vy = pp["amp"] * torch.cos(2 * math.pi * x / pp["L_x"]) * torch.exp(-((y - y_if) / 0.05) ** 2)
    u = fill_from_prim(sim, u, rho, (0.0, vy, 0.0), p=p)
    zero = torch.zeros(shape, dtype=u.dtype, device=u.device)
    return u, (_full(shape, pp["B_0"], u), zero, zero)


# ---------------------------------------------------------------------------
# species advection (Exec/mhd_tests/species): a two-species contact

SPECIES_DEFAULTS = dict(rho=1.0, p=1.0, u_x=1.0, u_y=1.0, u_z=1.0, B_x=1e-3, B_y=0.0, B_z=0.0,
                        frac=0.5)


def species_params(n=64, **prob):
    merged = dict(SPECIES_DEFAULTS)
    merged.update(prob)
    p = _base_params((n,), (0.0,), (1.0,), (0,), (0,), 5.0 / 3.0, **merged)
    return p.with_ns("network", network_name="general_null", spec_names=("A", "B"))


def species_init(msim, u, b):
    pp = _pp(msim, SPECIES_DEFAULTS)
    sim = _base(msim)
    shape = u.shape[1:]
    x = sim.geom.cell_centers(0, sim.ng).expand(shape)
    xa = torch.where(x < pp["frac"], 1.0, 0.0).to(u.dtype)
    u = fill_from_prim(sim, u, pp["rho"], (pp["u_x"], pp["u_y"], pp["u_z"]), p=pp["p"],
                       xn=torch.stack([xa, 1.0 - xa]))
    return u, tuple(_full(shape, pp[f"B_{c}"], u) for c in "xyz")
