"""Radiating sphere (counterpart of `castro_tpu/problems/rad_sphere.py`;
reference `Exec/radiation_tests/RadSphere`, Graziani 2008 / Swesty & Myra
2009): a hot (1500 eV) sphere of radius 0.02 cm at the inner boundary of a
1D spherical shell radiates into a cold (50 eV) ambient medium whose
opacity kappa = 1e13 (nu_0/nu)^3 is thick at low frequency and thin at
high frequency. 60 log-spaced groups; the analytic group spectrum at
(r, t) is

  E_g(r,t) = [B(nu,T_0) + (R/r)(B(nu,T_s) - B(nu,T_0)) F(r,t,nu)] dnu

with F the erfc expression of Swesty & Myra eq. 76-77."""

from __future__ import annotations

import math

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.utils import constants as C

NGROUPS = 60
NU_LO = 1.2089946159439434e14   # 0.5 eV
NU_HI = 7.3990470495769334e19   # 306 keV
NU_0 = 3.6e14                    # opacity reference frequency (Hz)
KAPPA_0 = 1.0e13                 # kappa at nu_0 (1/cm)
R_SPHERE = 0.02
R_OBS = 0.06
T_SPHERE = 1500.0 * C.ev2erg / C.k_B
T_0 = 5.8022593689285789e5       # ambient temperature (K)


def groups():
    """Log-spaced group edges, centres and widths (radiation.lowestGroupHz
    .. highestGroupHz, nGroups=60)."""
    xnu = np.geomspace(NU_LO, NU_HI, NGROUPS + 1)
    return xnu, np.sqrt(xnu[:-1] * xnu[1:]), np.diff(xnu)


def planck(nu, T):
    """Blackbody energy density B = (4 pi / c) I [erg/cm^3/Hz]."""
    x = np.minimum(C.hplanck * nu / (C.k_B * T), 700.0)
    B = (8.0 * math.pi * C.hplanck * nu ** 3 / C.c_light ** 3) / np.expm1(x)
    return np.clip(B, 1e-50, 1e200)


def analytic_spectrum(r, t):
    """E_g(r, t) (Swesty & Myra 2009 eq. 76-77)."""
    from scipy.special import erfc

    _, nu_c, dnu = groups()
    kappa = KAPPA_0 * (NU_0 / nu_c) ** 3
    arg = np.sqrt(3.0 * kappa / (4.0 * C.c_light * max(t, 1e-50)))
    s = np.sqrt(C.c_light * t * kappa)

    def sferfc(a):
        return erfc(np.clip(a, -26.0, 26.0))

    def sfexp(a):
        return np.exp(np.clip(a, -650.0, 650.0))

    F = 0.5 * (sfexp(-np.sqrt(3.0) * kappa * (r - R_SPHERE)) * sferfc(arg * (r - R_SPHERE) - s)
               + sfexp(np.sqrt(3.0) * kappa * (r - R_SPHERE)) * sferfc(arg * (r - R_SPHERE) + s))
    F = np.clip(F, 1e-50, 1e200)
    E = planck(nu_c, T_0) + (R_SPHERE / r) * (planck(nu_c, T_SPHERE) - planck(nu_c, T_0)) * F
    return E * dnu


def make_params(n=256, dtype="float64"):
    p = Params()
    p = p.with_ns("amr", n_cell=(n,))
    p = p.with_ns("geometry", coord_sys=2, prob_lo=(R_SPHERE, 0.0, 0.0), prob_hi=(0.2, 1.0, 1.0))
    p = p.with_ns("castro", lo_bc=(3,), hi_bc=(2,), do_hydro=0, do_radiation=1, fixed_dt=1e-15,
                  small_temp=0.0)
    p = p.with_ns("eos", eos_name="rad_power_law", eos_gamma=5.0 / 3.0)
    p = p.replace(extra={"eos.const_c_v": 1.0e8})
    # the nu^-3 opacity as absorption against the fixed-temperature ambient
    # matter: the analytic spectrum's steady exp(-sqrt(3) kappa (r-R))
    # attenuation comes from the -c kappa (E - B(T_0)) sink, which pure
    # scattering cannot give in the zeroth-moment equation
    p = p.with_ns("radiation", ngroups=NGROUPS, lo_bc=(101, 0, 0), hi_bc=(101, 0, 0),
                  const_kappa_p=4.6656e56, kappa_p_exp_p=-3.0,
                  const_kappa_r=4.6656e56, kappa_r_exp_p=-3.0, limiter=0, outer_iters=2)
    p = p.with_ns("tpu", dtype=dtype)
    return p


def run(n=256, t_end=1.0e-12, dt=2.0e-15, device=None):
    """Evolve the multigroup field alone (matter held at T_0 and rho = 1);
    returns (r, Er [ng, n] as numpy, the FLDRadiation)."""
    from castro_tpu_torch.geometry import geometry_from_params, resolve_device
    from castro_tpu_torch.radiation.fld import FLDRadiation
    from castro_tpu_torch.state import layout_from_params

    dev = resolve_device(device)
    params = make_params(n=n)
    geom = geometry_from_params(params, torch.float64, dev)
    fld = FLDRadiation(params, geom, layout_from_params(params))
    _, nu_c, dnu = groups()
    # the hot sphere's Planck spectrum as each group's Dirichlet value at
    # r-lo, the ambient one at r-hi (reference Tools/radbc.f90)
    fld.bc_group_vals_lo = planck(nu_c, T_SPHERE) * dnu
    fld.bc_group_vals_hi = planck(nu_c, T_0) * dnu
    metric = fld.geom_metric()

    f64 = dict(dtype=torch.float64, device=dev)
    Er = torch.as_tensor(planck(nu_c, T_0)[:, None] * dnu[:, None] * np.ones((1, n)), **f64)
    rho = torch.ones(n, **f64)
    cv = torch.full((n,), 1.0e8, **f64)
    T = torch.full((n,), T_0, **f64)
    e_m = cv * T
    for _ in range(int(round(t_end / dt))):
        Er, e_m, _ = fld.multigroup_update(Er, rho, e_m, T, cv, dt, nu_c, dnu, metric=metric)
    return geom.cell_centers_1d(0, 0).cpu().numpy(), Er.cpu().numpy(), fld


def score(r, Er, t):
    """tests/test_rad_sphere.py's comparison of the group spectrum at
    R_OBS with the analytic one at time t, on its bright part: the median
    and largest relative error (limits 0.10 and 0.6), the integrated
    energy's (0.15) and the peak's shift in groups (1). Returns the four
    and whether all hold."""
    i_obs = int(np.argmin(np.abs(r - R_OBS)))
    E_num, E_ana = Er[:, i_obs], analytic_spectrum(r[i_obs], t)
    sel = E_ana > 1e-3 * E_ana.max()
    rel = np.abs(E_num[sel] - E_ana[sel]) / E_ana[sel]
    out = dict(r_obs=float(r[i_obs]), median_rel=float(np.median(rel)), max_rel=float(rel.max()),
               energy_rel=float(abs(E_num.sum() - E_ana.sum()) / E_ana.sum()),
               peak_shift=abs(int(np.argmax(E_num)) - int(np.argmax(E_ana))))
    out["ok"] = (out["median_rel"] < 0.10 and out["max_rel"] < 0.6 and out["energy_rel"] < 0.15
                 and out["peak_shift"] <= 1)
    return out


def main(argv=None):
    """python -m castro_tpu_torch.problems.rad_sphere [--dt DT] [--t-end T]
    [--n N] [--device cuda|cpu]: the run, scored as tests/test_rad_sphere.py
    scores it (which runs dt 1e-15 to 1e-12); one JSON line, exit 1 if a
    limit is missed."""
    import argparse
    import json
    import time

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--dt", type=float, default=1.0e-15)
    ap.add_argument("--t-end", type=float, default=1.0e-12)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    r, Er, fld = run(n=a.n, t_end=a.t_end, dt=a.dt, device=a.device)
    out = dict(n=a.n, dt=a.dt, t_end=a.t_end, steps=int(round(a.t_end / a.dt)),
               seconds=time.perf_counter() - t0,
               vcycles_per_group_solve=float(np.mean([c for c, _ in fld.solve_stats])),
               **score(r, Er, a.t_end))
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
