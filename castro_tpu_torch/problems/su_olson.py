"""Su & Olson non-equilibrium Marshak waves (counterpart of
`castro_tpu/problems/su_olson.py`; reference
`Exec/radiation_tests/RadSuOlson` and `RadSuOlsonMG`).

Gray (Su & Olson 1996, Hayes & Norman 2003 parameters): a cold slab with
cv = alpha T^3 (epsilon = 4a/alpha = 0.1), kappa = 1, no flux limiting
(lambda = 1/3), driven by a Marshak boundary with incident flux F_inc = 1
at x = 0. The dimensionless u(x_hat, tau) = c Er / (4 F_inc) and
v = c a T^4 / (4 F_inc), x_hat = sqrt(3) kappa x, tau = eps c kappa t,
have the published semi-analytic diffusion solution (Su & Olson 1996,
Table 2).

Multigroup (Su & Olson 1999): two picket-fence groups on [1e14, 1e16] Hz
with kappa(nu) = 1.98e-31 nu^2 (group opacities ~{0.02, 1.98}), the
emissivity split p = {0.5, 0.5} (problem_emissivity.H) and a volume
source qn = c a T0^4 / 2 per group in |x| <= x0 for t <= 10/c
(problem_rad_source.H)."""

from __future__ import annotations

import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.utils import constants as C

EPS = 0.1
ALPHA_CV = 3.02584e-13  # 4 a / eps

# the Su & Olson (1996) diffusion solution, as tabulated in the reference's
# analysis script (Exec/radiation_tests/RadSuOlson/python/paper.py)
TABLE = {
    0.01: dict(x=[0.1, 0.25, 0.5, 0.75, 1.0],
               u=[0.17979, 0.11006, 0.04104, 0.01214, 0.00268],
               xv=[0.1, 0.25, 0.5, 0.75],
               v=[0.00110, 0.00055, 0.00012, 0.00003]),
    0.3: dict(x=[0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0, 7.5],
              u=[0.44289, 0.38544, 0.30500, 0.24062, 0.18922, 0.04167, 0.00238, 0.00008],
              xv=[0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0, 7.5],
              v=[0.10124, 0.08551, 0.06437, 0.04830, 0.03612, 0.00584, 0.00020, 0.00001]),
}


def make_params(n=128, dtype="float64"):
    p = Params()
    p = p.with_ns("amr", n_cell=(n,), max_step=10 ** 6)
    p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(5.0, 1.0, 1.0))
    p = p.with_ns("castro", lo_bc=(2,), hi_bc=(2,), do_hydro=0, do_radiation=1,
                  fixed_dt=1.0e-13, small_temp=0.0, small_dens=1e-20, check_cfl_violation=0)
    p = p.with_ns("eos", eos_name="rad_power_law", eos_gamma=5.0 / 3.0)
    p = p.replace(extra={"eos.const_c_v": ALPHA_CV, "eos.c_v_exp_m": 0.0,
                         "eos.c_v_exp_n": -3.0})
    p = p.with_ns("radiation", lo_bc=(104, 0, 0), hi_bc=(102, 0, 0), lo_bcval=(1.0, 0.0, 0.0),
                  hi_bcval=(0.0, 0.0, 0.0), const_kappa_p=1.0, const_kappa_r=1.0, limiter=0)
    p = p.with_ns("tpu", dtype=dtype)
    return p


def problem_init(sim, u):
    L = sim.layout
    T0 = 1.0e-4  # a cold start
    f64 = dict(dtype=torch.float64, device=u.device)
    e0 = float(sim.eos.rt(rho=torch.ones((), **f64), T=torch.tensor(T0, **f64)).e)
    u = u.clone()
    u[L.URHO] = 1.0
    u[L.UTEMP] = T0
    u[L.UEINT] = e0
    u[L.UEDEN] = e0
    u[L.UFS] = 1.0
    return u


MG_T0 = 1.0e6
MG_X0 = 0.5
MG_T_STOP = 3.3356409519815202e-10  # 10 / c
MG_QN = 1.134074546528399e20        # c a T0^4 / 2 (per group)


def mg_params(n=512, dtype="float64"):
    p = Params()
    p = p.with_ns("amr", n_cell=(n,), max_step=10 ** 6)
    p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(102.4, 1.0, 1.0))
    p = p.with_ns("castro", lo_bc=(3,), hi_bc=(2,), do_hydro=0, do_radiation=1,
                  fixed_dt=3.3356409519815201e-12, small_temp=0.0, small_dens=1e-20,
                  check_cfl_violation=0)
    p = p.with_ns("eos", eos_name="rad_power_law", eos_gamma=5.0 / 3.0)
    p = p.replace(extra={"eos.const_c_v": 3.0262923999999999e-14, "eos.c_v_exp_m": 0.0,
                         "eos.c_v_exp_n": -3.0})
    p = p.with_ns("radiation", ngroups=2, solver_flag=6, lowest_group_hz=1.0e14,
                  highest_group_hz=1.0e16, lo_bc=(102, 0, 0), hi_bc=(102, 0, 0),
                  const_kappa_p=1.9801980198019803e-31, kappa_p_exp_p=2.0,
                  const_kappa_r=1.9801980198019803e-31, kappa_r_exp_p=2.0, limiter=0,
                  accelerate=0, outer_iters=8)
    p = p.with_ns("tpu", dtype=dtype)
    return p


def mg_init(sim, u):
    """A cold start; the source pulse dominates."""
    return problem_init(sim, u)


def mg_setup_radiation(sim, p0=0.5, p1=0.5):
    """The picket-fence emissivity split and the volume source
    (problem_emissivity.H, problem_rad_source.H)."""
    pf = torch.tensor([p0, p1], dtype=torch.float64, device=sim.device)

    def emissivity(T, nu_centers, dnu):
        sh = (-1,) + (1,) * T.dim()
        B = (C.a_rad * T ** 4)[None]
        dB = (4.0 * C.a_rad * T ** 3)[None]
        return pf.reshape(sh) * B, pf.reshape(sh) * dB

    sim.rad.emissivity_fn = emissivity

    def rad_source(s, t, dt):
        x = s.geom.cell_centers_1d(0)
        on = (torch.abs(x) <= MG_X0) & (t <= MG_T_STOP)
        q = torch.where(on, torch.full_like(x, MG_QN), torch.zeros_like(x))
        return q[None].expand((2,) + tuple(x.shape))

    sim.rad.rad_source_fn = rad_source
    sim.u_rad = torch.full((sim.layout.ngroups, sim.geom.n_cell[0]), 1e-10, dtype=sim.dtype,
                           device=sim.device)
