"""The reacting convergence tests (counterpart of
`castro_tpu/problems/reacting_tests.py`; reference
`Exec/reacting_tests/{reacting_convergence,bubble_convergence,nse_test}`).

- reacting_convergence: an isentropic pressure bump in a triple-alpha fuel
  ball (the reference's eos_input_ps: the isentrope through (rho0, T0) is
  tabulated and inverted in p).
- bubble_convergence: a hot bubble in an isentropic HSE helium atmosphere,
  triple-alpha burning under constant gravity.
- nse_test: a temperature-perturbed iron-group ball whose composition is
  the NSE distribution (aprox19 and `network/nse.py`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim

RC_DEFAULTS = dict(rho0=5.0e5, T0=3.0e8, dp_fact=2.0, L_pert=2.0e7)


def _axes(sim, shape, dtype):
    g = sim.geom
    return [g.cell_centers(d, sim.ng).expand(shape).to(dtype) for d in range(sim.layout.dim)]


def _centred_profile(sim, shape, dtype, L_pert):
    """(dist, exp(-(dist/L)^2) cos^6(pi dist/L_dom), the inside mask) about
    the domain's centre."""
    g = sim.geom
    center = [0.5 * (g.prob_lo[d] + g.prob_hi[d]) for d in range(sim.layout.dim)]
    dist = torch.sqrt(sum((a - c) ** 2 for a, c in zip(_axes(sim, shape, dtype), center)))
    Ldom = g.prob_hi[0] - g.prob_lo[0]
    prof = torch.exp(-((dist / L_pert) ** 2)) * torch.cos(math.pi * dist / Ldom) ** 6
    return prof, dist <= center[0]


def _host_interp(x, xp, fp, like):
    """np.interp of the tensor x on the host, back to like's device."""
    return torch.as_tensor(np.interp(x.cpu().numpy(), xp, fp), dtype=like.dtype,
                           device=like.device)


def reacting_convergence_params(n=64, dim=2, **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=(n,) * dim, stop_time=0.06)
    p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(1.0e8,) * 3)
    p = p.with_ns("castro", lo_bc=(0,) * dim, hi_bc=(0,) * dim, cfl=0.5, do_react=1,
                  small_dens=1e-5, small_temp=1e7)
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="triple_alpha_plus_cago")
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(RC_DEFAULTS, **prob))


def isentropic_bump(sim, u, pp, xn0):
    """rho, T on the isentrope through (rho0, T0) at p = p0 (1 + dp_fact
    exp(-(d/L)^2) cos^6(pi d/L_dom)) inside the ball (the reference's
    eos_input_ps initialization, shared with the general acoustic pulse)."""
    from castro_tpu_torch.utils.initial_models import HostEos, isentrope_through

    shape = tuple(u.shape[1:])
    tab = isentrope_through(sim.eos, pp["rho0"], pp["T0"], xn0)
    p0 = float(HostEos(sim.eos).state(pp["rho0"], pp["T0"], xn0).p[0])
    prof, inside = _centred_profile(sim, shape, u.dtype, pp["L_pert"])
    one = torch.ones_like(prof)
    p = p0 * torch.where(inside, 1.0 + pp["dp_fact"] * prof, one)
    return _host_interp(p, tab["p"], tab["rho"], u), _host_interp(p, tab["p"], tab["T"], u)


def _uniform_xn(xn0, u):
    shape = tuple(u.shape[1:])
    x = torch.as_tensor(np.asarray(xn0, dtype=np.float64), dtype=u.dtype, device=u.device)
    return x.reshape((-1,) + (1,) * len(shape)).expand((len(xn0),) + shape)


def reacting_convergence_init(sim, u):
    pp = dict(RC_DEFAULTS, **sim.params.problem)
    nspec = sim.layout.nspec
    small_x = 1e-10
    xn0 = np.full(nspec, small_x)
    xn0[0] = 1.0 - (nspec - 1) * small_x  # He4 fuel
    rho, T = isentropic_bump(sim, u, pp, xn0)
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), T=T, xn=_uniform_xn(xn0, u))


BC_DEFAULTS = dict(dens_base=1.0e7, temp_base=1.0e8, pert_width=2.56e5, do_pert=1)
BC_G = -1.0e10


def bubble_convergence_params(n=64, **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=(n, n), stop_time=0.1)
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(7.68e6, 7.68e6, 1.0))
    p = p.with_ns("castro", lo_bc=(0, 1, 0), hi_bc=(0, 1, 0), cfl=0.5, do_grav=1, do_react=1,
                  small_dens=1e-3, small_temp=1e6)
    p = p.with_ns("gravity", gravity_type="ConstantGrav", const_grav=BC_G)
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="triple_alpha_plus_cago")
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(BC_DEFAULTS, **prob))


def bubble_convergence_init(sim, u):
    """An isentropic HSE helium atmosphere; the bubble T *= 1 + 0.6 (1 +
    tanh(4 - r/w)) at constant pressure, rho from the EOS at (T, p)."""
    from castro_tpu_torch.problems.util import column_state
    from castro_tpu_torch.utils.initial_models import hse_plane_parallel

    pp = dict(BC_DEFAULTS, **sim.params.problem)
    g = sim.geom
    shape = tuple(u.shape[1:])
    y1 = g.cell_centers_1d(1, sim.ng).double().cpu().numpy()
    xn0 = np.zeros(sim.layout.nspec)
    xn0[0] = 1.0
    model = hse_plane_parallel(sim.eos, y1, pp["dens_base"], pp["temp_base"], BC_G,
                               lambda z: xn0, isentropic_until=float(y1[-1]) + 1.0, T_min=1e6)
    rho, T, _ = column_state(sim, u, model)
    rho, T = rho.to(u.dtype), T.to(u.dtype)
    p = sim.eos.rt(rho=rho, T=T).p
    if pp["do_pert"]:
        x, y = _axes(sim, shape, u.dtype)
        xc = 0.5 * (g.prob_lo[0] + g.prob_hi[0])
        yc = 0.5 * (g.prob_lo[1] + g.prob_hi[1])
        r = torch.sqrt((x - xc) ** 2 + (y - yc) ** 2) / pp["pert_width"]
        T = T * (1.0 + 0.6 * (1.0 + torch.tanh(4.0 - r)))
        rho = sim.eos.tp(T=T, p=p).rho
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), T=T, xn=_uniform_xn(xn0, u))


NSE_DEFAULTS = dict(rho0=1.0e9, T0=6.0e9, dT_fact=0.2, L_pert=2.0e7, ye0=0.5)


def nse_test_params(n=64, dim=1, **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=(n,) * dim, stop_time=1e-4)
    p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(1.0e8,) * 3)
    p = p.with_ns("castro", lo_bc=(0,) * dim, hi_bc=(0,) * dim, cfl=0.5, do_react=1,
                  small_dens=1e2, small_temp=1e8)
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="aprox19")
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(NSE_DEFAULTS, **prob))


def nse_test_init(sim, u):
    """A T bump; the composition is NSE at each zone's (rho0, T, ye0)."""
    from castro_tpu_torch.network.nse import make_nse_solver
    from castro_tpu_torch.utils.tmath import vmax

    pp = dict(NSE_DEFAULTS, **sim.params.problem)
    shape = tuple(u.shape[1:])
    prof, inside = _centred_profile(sim, shape, u.dtype, pp["L_pert"])
    T = pp["T0"] * torch.where(inside, 1.0 + pp["dT_fact"] * prof, torch.ones_like(prof))
    rho = torch.full(shape, pp["rho0"], dtype=u.dtype, device=u.device)
    ye = torch.full(shape, pp["ye0"], dtype=u.dtype, device=u.device)
    xn = make_nse_solver(sim.network)(rho, T, ye)
    xn = xn / vmax(torch.sum(xn, dim=0), 1e-300)[None]
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), T=T, xn=xn)
