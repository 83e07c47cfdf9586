"""sub_chandra (counterpart of `castro_tpu/problems/subchandra.py`;
reference `Exec/science/subchandra`): the double-detonation setup of a
sub-Chandrasekhar SN Ia, a CO white dwarf under a helium shell with a
tanh temperature perturbation at the shell's base, weighted by X(He4)
(`problem_initialize_state_data.H:25-86`). The subch network, Helmholtz,
MonopoleGrav and the sponge; 1D spherical or 2D RZ.

The reference reads a model file; here the spherical HSE model is built at
init (`utils/initial_models.wd_model_for_mass`), the shell's composition
hung on the mass coordinate, on the simulation's device."""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim, model_state
from castro_tpu_torch.utils import constants as C

DEFAULTS = dict(
    M_WD=1.0 * C.M_solar,     # CO core mass target
    M_He=0.05 * C.M_solar,    # He shell mass
    T_core=1.0e7,
    T_shell=2.0e8,
    pert_temp_factor=20.0,
    pert_rad_factor=8.0,
    R_pert=-1.0,              # < 0: the shell-base radius
    rho_cutoff=1.0e-4,
)

# subch species (network/subch.py)
IHE4, IC12, IO16, IN14 = 0, 1, 2, 13


def make_params(n=(128, 256), dim=2, **prob):
    p = Params()
    if dim == 1:
        p = p.with_ns("amr", n_cell=(n if np.isscalar(n) else n[0],))
        p = p.with_ns("geometry", coord_sys=2, prob_lo=(0.0, 0.0, 0.0),
                      prob_hi=(1.25e9, 1.0, 1.0))
        p = p.with_ns("castro", lo_bc=(3,), hi_bc=(2,))
    else:
        p = p.with_ns("amr", n_cell=tuple(n))
        p = p.with_ns("geometry", coord_sys=1, prob_lo=(0.0, -1.25e9, 0.0),
                      prob_hi=(1.25e9, 1.25e9, 1.0))
        p = p.with_ns("castro", lo_bc=(3, 2), hi_bc=(2, 2))
    p = p.with_ns("castro", do_grav=1, do_react=1, do_sponge=1, small_dens=1e-5,
                  small_temp=1e5, cfl=0.5, sponge_upper_density=1e-2,
                  sponge_lower_density=1e-4, sponge_timescale=1e-3)
    p = p.with_ns("gravity", gravity_type="MonopoleGrav")
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="subch", nspec=17)
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(DEFAULTS, **prob))


def build_model(sim, nshell=1024):
    """The CO white dwarf under its He shell, nshell shells out to 1.1 x the
    domain, its total mass found by the batched bisection walk on the
    simulation's device; `R_shell_base` is where He first dominates."""
    from castro_tpu_torch.utils.initial_models import wd_model_for_mass

    pp = dict(DEFAULTS, **sim.params.problem)
    nspec = sim.layout.nspec
    rmax = float(sim.geom.prob_hi[0]) * 1.1
    r = np.linspace(rmax / (2 * nshell), rmax, nshell)
    f64 = dict(dtype=torch.float64, device=sim.device)
    co = torch.zeros(nspec, **f64)
    co[IC12] = co[IO16] = 0.5
    he = torch.zeros(nspec, **f64)
    he[IHE4] = 0.99
    he[IN14] = 0.01  # the N14 admixture behind subch's bypass
    T_core = torch.tensor(pp["T_core"], **f64)
    T_shell = torch.tensor(pp["T_shell"], **f64)
    M_core = pp["M_WD"]

    def xn_of_m(m):
        return torch.where(m <= M_core, co, he)

    def T_of_rho(rho):
        return torch.where(rho > 1e5, T_core, T_shell)

    model = wd_model_for_mass(sim.eos, r, M_core + pp["M_He"], pp["T_core"], xn_of_m,
                              T_of_rho=T_of_rho, rho_cutoff=pp["rho_cutoff"], device=sim.device)
    idx = np.argwhere(model[f"spec_{IHE4}"] > 0.5)
    model["R_shell_base"] = float(model["r"][idx.min()]) if idx.size else 0.8 * rmax
    return model


def problem_init(sim, u, model=None):
    pp = dict(DEFAULTS, **sim.params.problem)
    L, g = sim.layout, sim.geom
    shape = tuple(u.shape[1:])
    model = model if model is not None else build_model(sim)
    x = g.cell_centers(0, sim.ng).expand(shape).to(u.dtype)
    if L.dim == 1:
        dist, xoff, yoff = x, x, torch.zeros_like(x)
    else:
        y = g.cell_centers(1, sim.ng).expand(shape).to(u.dtype)
        dist, xoff, yoff = torch.sqrt(x * x + y * y), x, y
    rho, T, xn = model_state(sim, u, model, dist, L.nspec)

    # the tanh perturbation at the shell's base, weighted by X(He4)
    R_pert = pp["R_pert"] if pp["R_pert"] > 0 else model["R_shell_base"]
    r1 = torch.sqrt(xoff ** 2 + (yoff - R_pert) ** 2) / (2.5e6 * pp["pert_rad_factor"])
    T = T * (1.0 + xn[IHE4] * pp["pert_temp_factor"] * (0.150 * (1.0 + torch.tanh(2.0 - r1))))
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), T=T, xn=xn)
