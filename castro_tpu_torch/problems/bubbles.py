"""The buoyant-bubble tests (counterpart of `castro_tpu/problems/bubbles.py`;
reference `Exec/hydro_tests/gamma_law_bubble` and `double_bubble`):
hydrostatic plane-parallel atmospheres under constant gravity with one or
two perturbed bubbles.

- gamma_law_bubble: an isobaric temperature perturbation on the gamma law.
- double_bubble: two density-deficit bubbles of different species on the
  multigamma EOS (`eos.species_gammas`), so that they buoy alike but
  evolve with different gammas.
"""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim

DEFAULTS = dict(pert_factor=8.1e-3, dens_base=1.65e-3, pres_base=1.65e6,
                y_pert_center=0.7, pert_width=0.025, do_isentropic=0,
                single=0, left_bubble_x_center=0.75, right_bubble_x_center=1.25)
G_CONST = -1.0e9


def _hse_column(y, dens_base, pres_base, g, gamma, do_isentropic):
    """The `initial_model.H` column: the isothermal (exp) or isentropic
    density profile and the midpoint hydrostatic pressure (numpy)."""
    y = np.asarray(y, dtype=float)
    H = pres_base / dens_base / abs(g)
    y0 = y[0]
    if do_isentropic:
        rho = dens_base * np.maximum(
            g * dens_base * (gamma - 1.0) * (y - y0) / (gamma * pres_base) + 1.0,
            1e-30) ** (1.0 / (gamma - 1.0))
    else:
        rho = dens_base * np.exp(-(y - y0) / H)
    p = np.empty_like(rho)
    p[0] = pres_base
    dy = y[1] - y[0]
    for j in range(1, len(y)):
        p[j] = p[j - 1] - dy * 0.5 * (rho[j] + rho[j - 1]) * abs(g)
    return rho, p


def _base_params(n, eos_ns, lo_bc=(0, 1), hi_bc=(0, 1), stop_time=4.5e-5, **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=tuple(n), stop_time=stop_time)
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(2.0, 2.0, 1.0))
    p = p.with_ns("castro", lo_bc=tuple(lo_bc) + (0,), hi_bc=tuple(hi_bc) + (0,), cfl=0.5,
                  do_grav=1, ppm_type=1, use_flattening=1, small_dens=1e-8, small_temp=1e-8,
                  small_pres=1e-12)
    p = p.with_ns("gravity", gravity_type="ConstantGrav", const_grav=G_CONST)
    for k, v in eos_ns.items():
        p = p.with_ns("eos", **{k: v})
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(DEFAULTS, **prob))


def _columns(sim, u, gamma, pp):
    """rho, p [grid] of the HSE column, and the cell centres x, y."""
    g = sim.geom
    shape = tuple(u.shape[1:])
    y1 = g.cell_centers_1d(1, sim.ng).double().cpu().numpy()
    rho1, p1 = _hse_column(y1, pp["dens_base"], pp["pres_base"], G_CONST, gamma,
                           pp["do_isentropic"])

    def col(a):
        return torch.as_tensor(a, dtype=u.dtype, device=u.device)[None, :].expand(shape)

    x = g.cell_centers(0, sim.ng).expand(shape).to(u.dtype)
    y = g.cell_centers(1, sim.ng).expand(shape).to(u.dtype)
    return col(rho1), col(p1), x, y


def gamma_law_params(n=(128, 128), gamma=1.4, **prob):
    return _base_params(n, dict(eos_gamma=gamma), **prob)


def gamma_law_init(sim, u):
    """The isobaric bump T *= 1 + pert_factor (1 + tanh(2 - r/width)), rho
    from (T, p) (for the gamma law, rho ~ p/T)."""
    pp = dict(DEFAULTS, **sim.params.problem)
    g = sim.geom
    rho, p, x, y = _columns(sim, u, sim.eos.gamma, pp)
    x1 = 0.5 * (g.prob_lo[0] + g.prob_hi[0])
    r1 = torch.sqrt((x - x1) ** 2 + (y - pp["y_pert_center"]) ** 2) / pp["pert_width"]
    es0 = sim.eos.rp(rho=rho, p=p)
    T = es0.T * (1.0 + pp["pert_factor"] * (1.0 + torch.tanh(2.0 - r1)))
    return fill_from_prim(sim, u, rho * es0.T / T, (0.0, 0.0, 0.0), p=p)


def double_bubble_params(n=(128, 128), gammas=(1.666, 1.4, 1.666), **prob):
    """Species 0 the ambient gas, 1 the left bubble, 2 the right one, each
    with its gamma (`eos.species_gammas`, EOS_DIR=multigamma)."""
    p = _base_params(n, dict(eos_name="multigamma"), **prob)
    p = p.with_ns("network", network_name="general_null", spec_names=("X", "A", "B"))
    return p.replace(extra=dict(p.extra, **{"eos.species_gammas": tuple(gammas)}))


def double_bubble_init(sim, u):
    """Two rho-deficit bubbles, each of its own species; e from the EOS at
    (rho_pert, p), the pressure unchanged."""
    pp = dict(DEFAULTS, **sim.params.problem)
    g = sim.geom
    gam0 = float(sim.eos.gammas[0]) if hasattr(sim.eos, "gammas") else 1.666
    rho, p, x, y = _columns(sim, u, gam0, pp)
    yc, w = pp["y_pert_center"], pp["pert_width"]
    if pp["single"]:
        centers = [(0.5 * (g.prob_lo[0] + g.prob_hi[0]), 1)]
    else:
        centers = [(pp["left_bubble_x_center"], 1), (pp["right_bubble_x_center"], 2)]
    nspec = sim.layout.nspec
    pert = torch.zeros_like(rho)
    xn = torch.zeros((nspec,) + tuple(rho.shape), dtype=u.dtype, device=u.device)
    xn[0] = 1.0
    for xc, isp in centers:
        r = torch.sqrt((x - xc) ** 2 + (y - yc) ** 2) / w
        inb = r < 2.0
        pert = torch.where(inb, pp["pert_factor"] * (1.0 + torch.tanh(2.0 - r)), pert)
        for m in range(nspec):
            xn[m] = torch.where(inb, torch.full_like(pert, 1.0 if m == isp else 0.0), xn[m])
    return fill_from_prim(sim, u, rho * (1.0 - pert), (0.0, 0.0, 0.0), p=p, xn=xn)
