"""flame_wave (counterpart of `castro_tpu/problems/flame_wave.py`; reference
`Exec/science/flame_wave`, BASELINE A5): a helium flame spreading through
an accreted layer on a neutron star, the reference's headline GPU
benchmark. CTU hydro, the Helmholtz EOS, aprox13 Strang burning, thermal
conduction, constant gravity and an HSE lower boundary, in 2D as the JAX
package has it.

The hydrostatic He layer is built in place, an isothermal column
integrated through the EOS (`_hse_column`, the JAX package's march with
its 12 Newton iterations a level, on the host), standing in for the
reference's initial-model file, with a hot ignition patch at the base."""

from __future__ import annotations

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.utils.initial_models import HostEos

DENS_BASE = 2.0e6      # g/cc at the layer's base
T_BASE = 2.0e8         # K
T_HOT = 4.0e8          # the ignition patch
G_CONST = -1.5e14      # cm/s^2, a neutron star's surface gravity
GAMMA = 5.0 / 3.0
WIDTH, HEIGHT = 2.0e3, 1.0e3  # cm


def make_params(n=(128, 64), dtype="float64"):
    p = Params()
    p = p.with_ns("amr", n_cell=tuple(n))
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(WIDTH, HEIGHT, HEIGHT))
    # x: periodic, the flame's direction; y: the HSE base (an inflow face
    # with the fill hook) and an outflow top
    p = p.with_ns("castro", lo_bc=(0, 1), hi_bc=(0, 2), do_grav=1, do_react=1,
                  do_thermal_diffusion=1, small_dens=1e-5, small_temp=1e6, small_pres=1e10,
                  dtnuc_e=0.25, cfl=0.5)
    p = p.with_ns("gravity", gravity_type="ConstantGrav", const_grav=G_CONST)
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="aprox13")
    p = p.replace(extra={"conductivity.const_conductivity": 1.0e18})
    return p.with_ns("tpu", dtype=dtype)


def _hse_column(eos, xn_col, z, rho0, T):
    """An isothermal HSE column integrated upward through the EOS, on the
    host: at each level 12 Newton iterations on p(rho, T) = p_below +
    rho_avg g dz. Returns (rho, p) as numpy arrays."""
    heos = HostEos(eos)
    n = z.shape[0]
    rho, p = np.zeros(n), np.zeros(n)
    rho[0] = rho0
    p[0], _, _ = heos.p_dpdr_gam1(rho0, T, xn_col)
    dz = float(z[1] - z[0])
    for i in range(1, n):
        r = rho[i - 1]
        for _ in range(12):
            pi, dpdr, _ = heos.p_dpdr_gam1(r, T, xn_col)
            f = pi - (p[i - 1] + 0.5 * (rho[i - 1] + r) * G_CONST * dz)
            df = dpdr - 0.5 * G_CONST * dz
            r = max(r - f / df, 1e-5)
        rho[i] = r
        p[i], _, _ = heos.p_dpdr_gam1(r, T, xn_col)
    return rho, p


def problem_init(sim, u):
    L, ng, geom = sim.layout, sim.ng, sim.geom
    z1 = geom.cell_centers_1d(1, ng).double().cpu().numpy()
    x1 = geom.cell_centers_1d(0, ng).double().cpu().numpy()
    xn_col = np.zeros(L.nspec)
    xn_col[0] = 1.0  # pure He4
    rho_col, _ = _hse_column(sim.eos, xn_col, z1 - z1[0], DENS_BASE, T_BASE)

    f64 = dict(dtype=torch.float64, device=u.device)
    shape = u.shape[1:]
    rho = torch.as_tensor(rho_col, **f64)[None, :].expand(shape)
    X = torch.as_tensor(x1, **f64)[:, None].expand(shape)
    Z = torch.as_tensor(z1, **f64)[None, :].expand(shape)
    # the hot ignition patch at the base, a quarter of the way along x
    x0 = 0.25 * float(geom.prob_hi[0])
    r2 = ((X - x0) / 150.0) ** 2 + ((Z - float(z1[ng])) / 100.0) ** 2
    T = T_BASE + (T_HOT - T_BASE) * torch.exp(-r2)
    xn = torch.zeros((L.nspec,) + tuple(shape), **f64)
    xn[0] = 1.0
    es = sim.eos.rt(rho=rho, T=T, xn=xn)
    u = u.clone()
    u[L.URHO] = rho
    u[L.UMX] = 0.0
    u[L.UMY] = 0.0
    u[L.UMZ] = 0.0
    u[L.UEINT] = rho * es.e
    u[L.UEDEN] = rho * es.e
    u[L.UTEMP] = T
    u[L.UFS:L.UFS + L.nspec] = rho[None] * xn
    return u


def build(n=(128, 64), dtype="float64", device=None):
    """The configured Simulation with its HSE lower fill (on the card unless
    `device` says else)."""
    from castro_tpu_torch.driver.sim import Simulation
    from castro_tpu_torch.problems.fills import make_hse_fill

    holder = {}
    sim = Simulation(make_params(n=n, dtype=dtype), problem_init=problem_init, device=device,
                     problem_fill=lambda u, t=0.0: holder["hse"](u))
    holder["hse"] = make_hse_fill(sim, [(1, "lo")], G_CONST)
    return sim
