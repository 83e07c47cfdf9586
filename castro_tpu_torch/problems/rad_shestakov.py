"""RadShestakovBolstad (counterpart of `castro_tpu/problems/rad_shestakov.py`;
reference `Exec/radiation_tests/RadShestakovBolstad`): the Shestakov &
Bolstad (2005) multigroup sub-diffusive wave, a half-space of hot matter
radiating into cold surroundings with kappa ~ nu^-3 and a T-linearized
picket-fence emissivity (`problem_emissivity.H`), 64 geometric-width
groups (`inputs.common`: lowestGroupHz=0, groupGrowFactor=1.1,
firstGroupWidthHz=1.209e13), no hydro, no f-space advection."""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim
from castro_tpu_torch.utils import constants as C

DEFAULTS = dict(rho_0=1.8212111e-5, T_0=0.1, kappa_0=4.0628337e43, x_jump=0.5)

NGROUPS = 64
CV = 99968636.6828


def make_params(n=256, ngroups=NGROUPS, **prob):
    merged = dict(DEFAULTS)
    merged.update(prob)
    p = Params()
    p = p.with_ns("amr", n_cell=(n,))
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(803587.93051665276, 1.0, 1.0))
    p = p.with_ns("castro", lo_bc=(3,), hi_bc=(2,), do_hydro=0, do_radiation=1, small_temp=0.0,
                  small_dens=1e-10)
    p = p.with_ns("eos", eos_name="rad_power_law")
    p = p.replace(extra={"eos.const_c_v": CV})
    p = p.with_ns("radiation", ngroups=ngroups, lowest_group_hz=0.0, group_grow_factor=1.1,
                  first_group_width_hz=1.2089946159439433e13,
                  const_kappa_p=merged["kappa_0"], kappa_p_exp_p=-3.0,
                  const_kappa_r=merged["kappa_0"], kappa_r_exp_p=-3.0,
                  limiter=2, outer_iters=6, lo_bc=(102, 0, 0), hi_bc=(102, 0, 0))
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=merged)


def scales(params):
    """The problem's scales (problem_initialize_state_data.H:10-20): Tcgs,
    nu0 = k Tcgs / h, l0 = nu0^3/kappa_0, x0 = l0/sqrt(3)."""
    pp = dict(DEFAULTS)
    pp.update(params.problem)
    Tcgs = pp["T_0"] * 1.0e3 * C.ev2erg / C.k_B
    nu0 = C.k_B * Tcgs / C.hplanck
    l0 = nu0 ** 3 / pp["kappa_0"]
    return dict(Tcgs=Tcgs, nu0=nu0, l0=l0, x0=l0 / np.sqrt(3.0))


def problem_init(sim, u):
    pp = dict(DEFAULTS)
    pp.update(sim.params.problem)
    sc = scales(sim.params)
    x = sim.geom.cell_centers(0, sim.ng).expand(tuple(u.shape[1:]))
    hot = torch.abs(x) / sc["x0"] < pp["x_jump"]
    T = torch.where(hot, torch.full_like(x, sc["Tcgs"]), torch.full_like(x, sc["Tcgs"] * 1e-12))
    return fill_from_prim(sim, u, torch.full_like(x, pp["rho_0"]), (0.0, 0.0, 0.0), T=T)


def setup_radiation(sim):
    """Er = 0 at the start, and the linearized picket-fence emissivity
    (problem_emissivity.H): S_g = dBdT T with dBdT = (8 pi k / c^3) nu_g^3
    (exp(-h nu_lo / k Tf) - exp(-h nu_hi / k Tf)), Tf the hot temperature."""
    Tf = scales(sim.params)["Tcgs"]
    xnu = np.asarray(sim.rad.xnu)
    nug = np.asarray(sim.rad.nugroup)
    hoverk = C.hplanck / C.k_B
    cB = 8.0 * np.pi * C.k_B / C.c_light ** 3
    dBdT = cB * nug ** 3 * (np.exp(-hoverk * xnu[:-1] / Tf) - np.exp(-hoverk * xnu[1:] / Tf))
    dBdT_t = torch.as_tensor(dBdT, dtype=torch.float64, device=sim.device)

    def emissivity(T, nu_centers, dnu):
        sh = (-1,) + (1,) * T.dim()
        S_g = dBdT_t.reshape(sh) * T[None]
        return S_g, dBdT_t.reshape(sh).expand(S_g.shape)

    sim.rad.emissivity_fn = emissivity
    sim.u_rad = torch.zeros((sim.layout.ngroups, sim.geom.n_cell[0]), dtype=sim.dtype,
                            device=sim.device)
