"""massive_star (counterpart of `castro_tpu/problems/massive_star.py`;
reference `Exec/science/massive_star`): the core of an evolved massive star
at the edge of collapse, an iron core under silicon, oxygen and helium
shells, burned by aprox19 with the NSE bypass past the thresholds. The
reference reads a 15 Msun MESA model; here a layered hydrostatic model is
built by the spherical march (one 768-shell march, compositions hung on
the mass coordinate). Helmholtz, MonopoleGrav and the sponge; 1D
spherical or 2D RZ."""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim, model_state, radius_from_origin
from castro_tpu_torch.utils import constants as C
from castro_tpu_torch.utils.tmath import vmax

DEFAULTS = dict(
    rho_c=5.0e9,           # central density (pre-collapse Fe core)
    T_c=8.0e9,             # central temperature
    M_fe=1.4 * C.M_solar,  # iron-core mass
    M_si=0.3 * C.M_solar,  # Si shell
    M_o=1.3 * C.M_solar,   # O shell
)

# aprox19 species
IH1, IHE4, IC12, IO16, ISI28, IFE54 = 0, 2, 3, 5, 8, 15


def make_params(n=256, dim=1, **prob):
    p = Params()
    if dim == 1:
        p = p.with_ns("amr", n_cell=(n,))
        p = p.with_ns("geometry", coord_sys=2, prob_lo=(0.0, 0.0, 0.0),
                      prob_hi=(5.0e9, 1.0, 1.0))
        p = p.with_ns("castro", lo_bc=(3,), hi_bc=(2,))
    else:
        p = p.with_ns("amr", n_cell=(n, 2 * n))
        p = p.with_ns("geometry", coord_sys=1, prob_lo=(0.0, -5.0e9, 0.0),
                      prob_hi=(5.0e9, 5.0e9, 1.0))
        p = p.with_ns("castro", lo_bc=(3, 2), hi_bc=(2, 2))
    p = p.with_ns("castro", do_grav=1, do_react=1, do_sponge=1, small_dens=1e-3,
                  small_temp=1e6, cfl=0.5, sponge_upper_density=1e2,
                  sponge_lower_density=1e0, sponge_timescale=1e-3)
    p = p.with_ns("gravity", gravity_type="MonopoleGrav")
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="aprox19", nspec=19, nse=1, rho_nse=2.0e8,
                  T_nse=5.0e9)
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(DEFAULTS, **prob))


def build_model(sim, nshell=768):
    from castro_tpu_torch.utils.initial_models import hse_spherical

    pp = dict(DEFAULTS, **sim.params.problem)
    nspec = sim.layout.nspec
    rmax = float(sim.geom.prob_hi[0]) * 1.05
    r = np.linspace(rmax / (2 * nshell), rmax, nshell)
    m1 = pp["M_fe"]
    m2 = m1 + pp["M_si"]
    m3 = m2 + pp["M_o"]

    def layer(idx):
        xn = torch.zeros(nspec, dtype=torch.float64, device=sim.device)
        xn[idx] = 1.0
        return xn

    fe, si, ox, he = (layer(i) for i in (IFE54, ISI28, IO16, IHE4))

    def xn_of_m(m):
        return torch.where(m <= m1, fe, torch.where(m <= m2, si, torch.where(m <= m3, ox, he)))

    def T_of_rho(rho):
        # T ~ rho^(1/3) anchored at (rho_c, T_c), floored in the envelope
        return vmax(pp["T_c"] * (vmax(rho, 1.0) / pp["rho_c"]) ** (1.0 / 3.0), 1.0e8)

    return hse_spherical(sim.eos, r, pp["rho_c"], pp["T_c"], xn_of_m, T_of_rho=T_of_rho,
                         rho_cutoff=1.0e-3, device=sim.device)


def problem_init(sim, u, model=None):
    model = model if model is not None else build_model(sim)
    dist = radius_from_origin(sim, tuple(u.shape[1:])).to(u.dtype)
    rho, T, xn = model_state(sim, u, model, dist, sim.layout.nspec)
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), T=T, xn=xn)
