"""wdmerger (counterpart of `castro_tpu/problems/wdmerger.py`; reference
`Exec/science/wdmerger`): two white dwarfs, either the head-on collision
(problem=0, the `wdmerger_collision` test: both on the symmetry axis of a
2D RZ domain, falling toward each other at the two-body free-fall speed
from the initial separation) or the circular binary in the rotating frame
(problem=1). PoissonGrav with max_multipole_order=6, Helmholtz, the
sponge. Each star is built by the batched bisection walk
(`utils/initial_models.wd_model_for_mass`) and the two are superposed on a
low-density ambient."""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim, model_state
from castro_tpu_torch.utils import constants as C

DEFAULTS = dict(
    mass_P=0.64,               # solar masses
    mass_S=0.64,
    problem=0,                 # 0: collision, 1: circular binary
    collision_separation=2.0,  # in secondary radii
    stellar_temp=1.0e7,
    ambient_density=1.0e-4,
    rotational_period=100.0,   # s (problem=1)
)


def make_params(n=(64, 128), **prob):
    merged = dict(DEFAULTS, **prob)
    p = Params()
    p = p.with_ns("amr", n_cell=tuple(n))
    p = p.with_ns("geometry", coord_sys=1, prob_lo=(0.0, -5.12e9, 0.0),
                  prob_hi=(5.12e9, 5.12e9, 1.0))
    p = p.with_ns("castro", lo_bc=(3, 2), hi_bc=(2, 2), do_grav=1, do_react=0,
                  small_dens=1e-5, small_temp=1e5, cfl=0.5, do_sponge=1,
                  sponge_upper_density=1e-2, sponge_lower_density=1e-4,
                  sponge_timescale=1e-2)
    if merged["problem"] == 1:
        p = p.with_ns("castro", do_rotation=1, rotational_period=merged["rotational_period"])
    p = p.with_ns("gravity", gravity_type="PoissonGrav", max_multipole_order=6)
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="general_null", nspec=3,
                  spec_names=("He4", "C12", "O16"))
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=merged)


def _wd(sim, mass_msol, T, nshell=512):
    """A C/O white dwarf of the given mass, 2e9 cm in nshell shells, and its
    radius (the last shell above the floor tail)."""
    from castro_tpu_torch.utils.initial_models import wd_model_for_mass

    rmax = 2.0e9
    xn_co = torch.tensor([0.0, 0.5, 0.5], dtype=torch.float64, device=sim.device)
    r = np.linspace(rmax / (2 * nshell), rmax, nshell)
    model = wd_model_for_mass(sim.eos, r, mass_msol * C.M_solar, T, lambda m: xn_co,
                              device=sim.device)
    rho = model["density"]
    live = rho > 1.5 * rho.min()
    R = float(r[np.argwhere(live).max()]) if live.any() else rmax
    return model, R


def build_models(sim):
    """(model_P, R_P, model_S, R_S) of the primary and the secondary."""
    pp = dict(DEFAULTS, **sim.params.problem)
    model_P, R_P = _wd(sim, pp["mass_P"], pp["stellar_temp"])
    model_S, R_S = _wd(sim, pp["mass_S"], pp["stellar_temp"])
    return model_P, R_P, model_S, R_S


def problem_init(sim, u, models=None):
    pp = dict(DEFAULTS, **sim.params.problem)
    L, g = sim.layout, sim.geom
    shape = tuple(u.shape[1:])
    model_P, R_P, model_S, R_S = models if models is not None else build_models(sim)
    M_P = pp["mass_P"] * C.M_solar
    M_S = pp["mass_S"] * C.M_solar

    # the stars' centres on the symmetry axis (2D RZ: x = r, y = z)
    sep = pp["collision_separation"] * 2.0 * R_S
    zP, zS = -0.5 * sep, 0.5 * sep
    # the two-body free fall from rest at infinity to the separation sep
    v_rel = np.sqrt(2.0 * C.Gconst * (M_P + M_S) / sep)
    vP = v_rel * M_S / (M_P + M_S)
    vS = -v_rel * M_P / (M_P + M_S)

    x = g.cell_centers(0, sim.ng).expand(shape).to(u.dtype)
    y = g.cell_centers(1, sim.ng).expand(shape).to(u.dtype)
    rho_P, T_P = model_state(sim, u, model_P, torch.sqrt(x * x + (y - zP) ** 2))
    rho_S, T_S = model_state(sim, u, model_S, torch.sqrt(x * x + (y - zS) ** 2))

    amb = pp["ambient_density"]
    in_P = rho_P > 10.0 * amb
    in_S = rho_S > 10.0 * amb
    rho = torch.clamp(torch.maximum(rho_P, rho_S), min=amb)
    T_amb = torch.full_like(rho, pp["stellar_temp"])
    T = torch.where(in_P, T_P, torch.where(in_S, T_S, T_amb))
    if pp["problem"] == 0:
        zero = torch.zeros_like(rho)
        vy = torch.where(in_P, zero + vP, torch.where(in_S, zero + vS, zero))
    else:
        # the circular binary: the rotating frame's state is static
        vy = torch.zeros_like(rho)
    xn = torch.zeros((L.nspec,) + shape, dtype=u.dtype, device=u.device)
    xn[1] = 0.5
    xn[2] = 0.5
    return fill_from_prim(sim, u, rho, (0.0, vy, 0.0), T=T, xn=xn)
