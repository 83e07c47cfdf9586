"""RadBreakout (counterpart of `castro_tpu/problems/rad_breakout.py`;
reference `Exec/radiation_tests/RadBreakout`): supernova shock breakout
from a red-supergiant envelope into a circumstellar wind, with gray
comoving-frame FLD rad-hydro in 1D spherical symmetry through the
operator-split step, the limiter and the primitives Purser-filtered.

The reference reads the SN 1987A snapshot `model.input.87a.23`; as in the
JAX package, an equivalent exploding envelope is generated analytically:
homologous ejecta (v = r/t_age) with rho ~ r^-n and a steep outer edge,
matched onto the reference's wind (`problem_initialize_state_data.H:
18-70`): log-log blending from the envelope edge (rbasefac) out to rwind0,
then a rho ~ r^-2, T ~ r^-1/2 steady wind normalized at rwind1."""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import fill_from_prim
from castro_tpu_torch.utils import constants as C

DEFAULTS = dict(rwind0=0.7e14, rwind1=1.0e14, rhowind1=1.0e-14, Twind1=1.1e3, rbasefac=0.99,
                # the analytic ejecta standing in for model.input.87a.23
                r_inner=6.85e10, r_edge=3.0e13, rho_inner=3.2e-3, T_inner=9.5e6, t_age=8.28e4,
                n_rho=1.2, n_outer=10.0)


def make_params(n=1024, **prob):
    merged = dict(DEFAULTS)
    merged.update(prob)
    p = Params()
    p = p.with_ns("amr", n_cell=(n,), stop_time=6000.0)
    p = p.with_ns("geometry", coord_sys=2, prob_lo=(0.0,) * 3, prob_hi=(1.0e14, 1.0, 1.0))
    p = p.with_ns("castro", lo_bc=(3,), hi_bc=(2,), cfl=0.6, do_radiation=1, init_shrink=0.01,
                  change_max=1.05, small_dens=1e-20, small_temp=1.0)
    p = p.with_ns("eos", eos_name="rad_power_law", eos_gamma=5.0 / 3.0)
    cv = C.k_B / (C.m_u * 0.6 * (5.0 / 3.0 - 1.0))  # ionized H/He
    p = p.replace(extra={"eos.const_c_v": cv})
    # electron scattering dominates: kappa [1/cm] = 0.2 rho (the H-poor 87A
    # envelope), with a small absorptive kappa_p
    p = p.with_ns("radiation", ngroups=1, lo_bc=(102,), hi_bc=(105,), const_kappa_p=4.0e-2,
                  kappa_p_exp_m=1.0, const_kappa_r=2.0e-1, kappa_r_exp_m=1.0, limiter=2,
                  closure=3, comoving=1, outer_iters=8, hydro_coupling=0, filter_lambda_T=4,
                  filter_prim_int=1, filter_prim_T=4)
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=merged)


def _envelope(r, pp):
    """The analytic ejecta + wind profile (numpy, float64)."""
    r = np.asarray(r, dtype=float)
    r_in, r_edge = pp["r_inner"], pp["r_edge"]
    rho_in, T_in = pp["rho_inner"], pp["T_inner"]
    n_rho, n_out = pp["n_rho"], pp["n_outer"]
    rwind0, rwind1 = pp["rwind0"], pp["rwind1"]
    rhowind1, Twind1 = pp["rhowind1"], pp["Twind1"]

    rr = np.maximum(r, r_in)
    rho_ej = rho_in * (rr / r_in) ** (-n_rho)
    rho_ej = np.where(rr > 0.8 * r_edge, rho_ej * (rr / (0.8 * r_edge)) ** (-n_out), rho_ej)
    T_ej = T_in * (rr / r_in) ** (-0.5)
    v_ej = rr / pp["t_age"]

    rlast = r_edge
    rholast = float(rho_in * (rlast / r_in) ** (-n_rho) * (rlast / (0.8 * r_edge)) ** (-n_out))
    Tlast = float(T_in * (rlast / r_in) ** (-0.5))
    rbase = rlast * pp["rbasefac"]
    rhowind0 = rhowind1 * (rwind1 / rwind0) ** 2
    Twind0 = Twind1 * (rwind1 / rwind0) ** 0.5

    with np.errstate(divide="ignore", invalid="ignore"):
        s = ((np.log(np.maximum(r - rbase, 1e-30)) - np.log(rlast - rbase)) /
             (np.log(rwind0 - rbase) - np.log(rlast - rbase)))
        rho_blend = rholast * (rhowind0 / rholast) ** s
        T_blend = Tlast * (Twind0 / Tlast) ** s
    rho_wind = rhowind1 * (rwind1 / np.maximum(r, 1.0)) ** 2
    T_wind = Twind1 * (rwind1 / np.maximum(r, 1.0)) ** 0.5

    rho = np.where(r <= rlast, rho_ej, np.where(r < rwind0, rho_blend, rho_wind))
    T = np.where(r <= rlast, T_ej, np.where(r < rwind0, T_blend, T_wind))
    v = np.where(r <= rlast, v_ej, 0.0)
    return rho, T, v


def problem_init(sim, u):
    pp = dict(DEFAULTS)
    pp.update(sim.params.problem)
    shape = tuple(u.shape[1:])
    r = sim.geom.cell_centers(0, sim.ng).expand(shape).double().cpu().numpy()
    rho, T, v = (torch.as_tensor(a, dtype=torch.float64, device=u.device)
                 for a in _envelope(r, pp))
    return fill_from_prim(sim, u, rho, (v, 0.0, 0.0), T=T)
