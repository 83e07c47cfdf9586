"""The convection tests (counterpart of `castro_tpu/problems/convect.py`;
reference `Exec/hydro_tests/toy_convect` and `test_convect`):
plane-parallel stellar atmospheres under constant gravity on the Helmholtz
EOS, driven by an initial row of vortices (toy_convect) or by a heating
layer modulated by three sinusoids in x (test_convect, its
`problem_source.H`, `make_test_convect_source`). The reference's model
files are built in place by the toy_atm and plane-parallel generators."""

from __future__ import annotations

import math

import numpy as np
import torch

from castro_tpu_torch.config import Params
from castro_tpu_torch.problems.util import column_state, fill_from_prim

TOY_DEFAULTS = dict(
    apply_vel_field=1, velpert_scale=1.0e6, velpert_amplitude=1.0e5,
    velpert_height_loc=4.1e8, num_vortices=2,
    dens_base=2.0e4, T_star=2.0e8, T_hi=2.0e8, T_lo=8.0e6,
    H_star=5.0e7, atm_delta=2.54e6,
)
TOY_G = -1.04263053e9


def toy_convect_params(n=(64, 128), **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=tuple(n), stop_time=1000.0)
    p = p.with_ns("geometry", prob_lo=(0.0, 3.5e8, 0.0), prob_hi=(7.5e7, 5.0e8, 1.0))
    p = p.with_ns("castro", lo_bc=(0, 1, 0), hi_bc=(0, 2, 0), cfl=0.7, do_grav=1, do_sponge=1,
                  init_shrink=0.1, change_max=1.1, sponge_upper_density=50.0,
                  sponge_lower_density=12.5, sponge_timescale=1e-3, small_dens=1e-5,
                  small_temp=1e5)
    p = p.with_ns("gravity", gravity_type="ConstantGrav", const_grav=TOY_G)
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="general_null", spec_names=("H1", "He4", "C12"))
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(TOY_DEFAULTS, **prob))


def toy_convect_init(sim, u):
    """The toy-nova atmosphere in height, and the alternating vortices of
    `problem_initialize_state_data.H:63-95` at x = (i + 1/2) Lx / num."""
    from castro_tpu_torch.utils.initial_models import toy_atm

    pp = dict(TOY_DEFAULTS, **sim.params.problem)
    g = sim.geom
    nspec = sim.layout.nspec
    y1 = g.cell_centers_1d(1, sim.ng).double().cpu().numpy()
    xn_star = np.zeros(nspec)
    xn_star[2] = 1.0  # the C/O ash substrate
    xn_base = np.zeros(nspec)
    xn_base[0] = 0.7  # the accreted H/He envelope
    xn_base[1] = 0.3
    model = toy_atm(sim.eos, y1, pp["dens_base"], pp["T_star"], pp["T_hi"], pp["T_lo"],
                    pp["H_star"], pp["atm_delta"], xn_star, xn_base, TOY_G)
    rho, T, xn = column_state(sim, u, model)
    shape = tuple(u.shape[1:])
    x = g.cell_centers(0, sim.ng).expand(shape).to(u.dtype)
    y = g.cell_centers(1, sim.ng).expand(shape).to(u.dtype)
    ux = torch.zeros(shape, dtype=u.dtype, device=u.device)
    uy = torch.zeros_like(ux)
    if pp["apply_vel_field"]:
        nv = int(pp["num_vortices"])
        Lx = g.prob_hi[0] - g.prob_lo[0]
        ydist = y - pp["velpert_height_loc"]
        s = pp["velpert_scale"]
        for v in range(nv):
            xdist = x - ((v + 0.5) * Lx / nv + g.prob_lo[0])
            r2 = xdist * xdist + ydist * ydist
            amp = pp["velpert_amplitude"] * torch.exp(-r2 / (2.0 * s * s)) * (-1.0) ** (v + 1)
            ux = ux + (-ydist / s) * amp
            uy = uy + (xdist / s) * amp
    return fill_from_prim(sim, u, rho, (ux, uy, 0.0), T=T, xn=xn)


TC_DEFAULTS = dict(dens_base=9.8e9, T_base=7.2e6, y_layer=1.25e8, heating_peak=2.5e16)
TC_G = -1.5e10


def test_convect_params(n=(160, 256), **prob):
    p = Params()
    p = p.with_ns("amr", n_cell=tuple(n), stop_time=5.0)
    p = p.with_ns("geometry", prob_lo=(0.0, 0.0, 0.0), prob_hi=(2.5e8, 4.0e8, 1.0))
    p = p.with_ns("castro", lo_bc=(0, 1, 0), hi_bc=(0, 2, 0), cfl=0.5, do_grav=1, do_sponge=1,
                  add_ext_src=1, init_shrink=0.1, ppm_type=1, use_flattening=1,
                  small_temp=5e6, small_dens=1e-5, sponge_upper_density=1e4,
                  sponge_lower_density=1e2, sponge_timescale=1e-3)
    p = p.with_ns("gravity", gravity_type="ConstantGrav", const_grav=TC_G)
    p = p.with_ns("eos", eos_name="helmholtz")
    p = p.with_ns("network", network_name="general_null", spec_names=("C12", "O16", "Mg24"))
    p = p.with_ns("tpu", dtype="float64")
    return p.replace(problem=dict(TC_DEFAULTS, **prob))


def test_convect_init(sim, u):
    """An isothermal plane-parallel HSE C/O atmosphere standing in for the
    reference's `model.hse` (rho_base 9.8e9, T 7.2e6, X(C12) 0.3)."""
    from castro_tpu_torch.utils.initial_models import hse_plane_parallel

    pp = dict(TC_DEFAULTS, **sim.params.problem)
    y1 = sim.geom.cell_centers_1d(1, sim.ng).double().cpu().numpy()
    xn0 = np.zeros(sim.layout.nspec)
    xn0[0] = 0.3
    xn0[1] = 0.7
    model = hse_plane_parallel(sim.eos, y1, pp["dens_base"], pp["T_base"], TC_G,
                               lambda z: xn0, T_min=1e6)
    rho, T, xn = column_state(sim, u, model)
    return fill_from_prim(sim, u, rho, (0.0, 0.0, 0.0), T=T, xn=xn)


def make_test_convect_source(params):
    """The heating layer of test_convect's `problem_source.H`: a Gaussian in
    y at y_layer, modulated by three sinusoids in x, rho H heating_peak into
    UEDEN and UEINT."""
    pp = dict(TC_DEFAULTS, **params.problem)
    y_layer = pp["y_layer"]
    peak = pp["heating_peak"]
    L_x = 2.5e8

    def ext_src(sim, u, q, qaux, t, dt, ctx=None):
        g = ctx.geom if ctx is not None else sim.geom
        L = sim.layout
        shape = tuple(u.shape[1:])
        x = g.cell_centers(0, sim.ng).expand(shape).to(u.dtype)
        y = g.cell_centers(1, sim.ng).expand(shape).to(u.dtype)
        ey = torch.exp(-(y - y_layer) ** 2 / 1e14)
        H = ey * (1.0 + 0.00625 * torch.sin(2 * math.pi * x / L_x)
                  + 0.01875 * torch.sin(6 * math.pi * x / L_x + math.pi / 3.0)
                  + 0.01250 * torch.sin(8 * math.pi * x / L_x + math.pi / 5.0))
        src = torch.zeros_like(u)
        rhoH = u[L.URHO] * H * peak
        src[L.UEDEN] = rhoH
        src[L.UEINT] = rhoH
        return src

    ext_src.name = "problem_source"
    return ext_src
