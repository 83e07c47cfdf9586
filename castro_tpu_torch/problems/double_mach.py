"""Double Mach reflection (reference `Exec/hydro_tests/double_mach_reflection`;
counterpart of `castro_tpu/problems/double_mach.py`): a Mach-10 shock
inclined 60 degrees to a reflecting wall (Woodward & Colella 1984). It
exercises time-dependent inflow boundaries: the y-hi ghost zones track the
analytic shock position xs(y, t) = 1/6 + y/tan(60) + (10/sin(60)) t
(reference `problem_bc_fill.H`), the x-lo face feeds the post-shock state,
and the y-lo face is post-shock for x < 1/6 and a reflecting wall beyond.
"""

from __future__ import annotations

import math

import torch

from castro_tpu_torch.config import Params

# post(l)/pre(r)-shock states (reference _prob_params)
P_L, U_L, V_L, RHO_L = 116.5, 7.1447096, -4.125, 8.0
P_R, U_R, V_R, RHO_R = 1.0, 0.0, 0.0, 1.4
GAMMA = 1.4
TAN60 = math.tan(math.pi / 3.0)
SHOCK_SPEED = 10.0 / math.sin(math.pi / 3.0)


def make_params(n=(256, 64), dtype="float64"):
    p = Params()
    p = p.with_ns("amr", n_cell=tuple(n), stop_time=0.2, max_step=100000)
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(4.0, 1.0, 1.0))
    # outflow bases everywhere; the problem fill drives the real BCs (the
    # reference inputs.2d has lo_bc/hi_bc = 2)
    p = p.with_ns("castro", lo_bc=(2, 2), hi_bc=(2, 2), cfl=0.9, init_shrink=0.01,
                  change_max=1.1, riemann_solver=2, ppm_type=1, small_dens=1e-8,
                  small_temp=1e-12, small_pres=1e-12)
    p = p.with_ns("eos", eos_gamma=GAMMA)
    p = p.with_ns("tpu", dtype=dtype)
    return p


def _conserved(rho, u, v, p):
    """(rho, rho u, rho v, rho E, rho e) of a constant gamma-law state."""
    rhoe = p / (GAMMA - 1.0)
    return (rho, rho * u, rho * v, rhoe + 0.5 * rho * (u * u + v * v), rhoe)


def _coords(sim, u):
    X = sim.geom.cell_centers(0, sim.ng).expand(u.shape[1:])
    Y = sim.geom.cell_centers(1, sim.ng).expand(u.shape[1:])
    return X, Y


def problem_init(sim, u):
    L = sim.layout
    X, Y = _coords(sim, u)
    post = Y >= TAN60 * (X - 1.0 / 6.0)
    u = u.clone()
    for comp, lv, rv in zip((L.URHO, L.UMX, L.UMY, L.UEDEN, L.UEINT),
                            _conserved(RHO_L, U_L, V_L, P_L), _conserved(RHO_R, U_R, V_R, P_R)):
        u[comp] = torch.where(post, torch.full_like(X, lv), torch.full_like(X, rv))
    u[L.UTEMP] = 1.0
    u[L.UFS] = u[L.URHO]
    return u


def make_problem_fill(sim_holder):
    """The (u, t) ghost-fill hook. `sim_holder` is a dict that the caller
    fills with {'sim': sim} once the simulation exists (the hook needs the
    layout and geometry of the simulation it serves)."""

    def problem_fill(u, t=0.0):
        sim = sim_holder["sim"]
        L = sim.layout
        ng = sim.ng
        ny = u.shape[2] - 2 * ng
        X, Y = _coords(sim, u)
        ii = torch.arange(u.shape[1], device=u.device).reshape(-1, 1)
        jj = torch.arange(u.shape[2], device=u.device).reshape(1, -1)
        in_xlo = ii < ng
        in_ylo = jj < ng
        in_yhi = jj >= ny + ng
        # y-hi: the analytic moving shock
        post = X < 1.0 / 6.0 + Y / TAN60 + SHOCK_SPEED * t
        # y-lo: a reflecting wall for x > 1/6, post-shock inflow before it
        wall = X >= 1.0 / 6.0
        out = u.clone()
        states = zip((L.URHO, L.UMX, L.UMY, L.UEDEN, L.UEINT, L.UTEMP),
                     _conserved(RHO_L, U_L, V_L, P_L) + (1.0,),
                     _conserved(RHO_R, U_R, V_R, P_R) + (1.0,))
        for comp, lv, rv in states:
            lvt, rvt = torch.full_like(X, lv), torch.full_like(X, rv)
            f = out[comp]
            f = torch.where(in_xlo, lvt, f)
            f = torch.where(in_yhi, torch.where(post, lvt, rvt), f)
            mirror = torch.flip(f[:, ng:2 * ng], dims=(1,))
            sgn = -1.0 if comp == L.UMY else 1.0
            refl = torch.cat([sgn * mirror, f[:, ng:]], dim=1)
            f = torch.where(in_ylo, torch.where(wall, refl, lvt), f)
            out[comp] = f
        out[L.UFS] = out[L.URHO]
        return out

    return problem_fill


def build(n=(256, 64), dtype="float64", device=None):
    """The configured Simulation (on the card unless `device` says else)."""
    from castro_tpu_torch.driver.sim import Simulation

    holder = {}
    sim = Simulation(make_params(n=n, dtype=dtype), problem_init=problem_init,
                     device=device, problem_fill=make_problem_fill(holder))
    holder["sim"] = sim
    return sim
