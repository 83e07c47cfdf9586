"""Radiation steps of the port against the JAX package's, from the same
state (the JAX initial state, converted) with the same dt: the
characteristic rad-CTU step (radiation.hydro_coupling=1, gray and
multigroup with f-space advection and Compton scattering), the
operator-split step (hydro_coupling=0: the hydro step on the radiation
layout, Er advection, the implicit update) and castro.do_hydro=0, in 1D
here, 2D in tests/test_torch_rad_steps_2d.py, 3D in
tests/test_torch_rad_steps_3d.py.

The JAX side runs `_jit_rad_step` (its multigrid solves jitted on their
own, tests/test_torch_radiation.py:make_jit_solve, inside it), or with
`eager` its `_rad_step_impl` op by op, which compiles less for the larger
grids. Tolerance: float64 1e-10 |jax| + 1e-10 max|jax| per component of
the interior state (the momenta sharing their largest maximum: a
transverse momentum that is zero but for round-off is held to the flow's
momentum) and of Er; float32 rtol = atol = 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from castro_tpu.config import Params as JParams
from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.problems.util import fill_from_prim as jfill

from castro_tpu_torch.config import Params
from castro_tpu_torch.driver.sim import Simulation

from test_torch_radiation import _few_threads, close, jit_jax_solve, t64  # noqa: F401


def box_params(P, n_cell, ngroups=1, split=0, do_hydro=1, coord=0, dtype="float64"):
    """A Sod-like tube with an Er pulse: every direction periodic, or RZ
    with a symmetry axis and outflow."""
    dim = len(n_cell)
    p = P().with_ns("amr", n_cell=tuple(n_cell))
    lo = (0.1, 0.0, 0.0) if coord else (0.0,) * 3
    p = p.with_ns("geometry", prob_lo=lo, prob_hi=(1.0,) * 3, coord_sys=coord)
    bc = (3,) + (2,) * (dim - 1) if coord else (0,) * dim
    p = p.with_ns("castro", lo_bc=bc, hi_bc=(2,) * dim if coord else bc, do_radiation=1,
                  do_hydro=do_hydro, small_dens=1e-12, small_temp=1e-12, small_pres=1e-15,
                  check_cfl_violation=0)
    mg = dict(lowest_group_hz=1e13, highest_group_hz=1e17,
              do_inelastic_scattering=1) if ngroups > 1 else {}
    p = p.with_ns("radiation", const_kappa_p=1e-3, const_kappa_r=1e4, limiter=2,
                  ngroups=ngroups, hydro_coupling=1 - split, **mg)
    return p.with_ns("eos", eos_gamma=5.0 / 3.0).with_ns("tpu", dtype=dtype)


def _jinit(sim, u):
    x = sim.geom.cell_centers(0, sim.ng)
    rho = jnp.broadcast_to(jnp.where(x < 0.55, 1.0, 0.25), sim.grown_shape())
    pres = jnp.broadcast_to(jnp.where(x < 0.55, 1.0, 0.3), sim.grown_shape())
    return jfill(sim, u, rho, (0.1, 0.05, 0.0), p=pres)


def steps_against_jax(jp, tp, dt=2e-3, steps=2, jinit=_jinit, er=None, dtype="float64",
                      setup=None, eager=False):
    """`steps` radiation steps of both packages from the JAX initial state
    (and `er`, a function of the JAX sim giving Er, else its equilibrium
    Er scaled into a pulse), compared after each step. `setup(jsim, tsim)`
    sets a problem's radiation hooks."""
    js = JSim(jp, problem_init=jinit)
    js.init_data()
    ts = Simulation(tp, device="cpu")
    if setup is not None:
        setup(js, ts)
    Er0 = np.asarray(js.u_rad) if er is None else np.asarray(er(js))
    if er is None:
        rng = np.random.default_rng(0)
        Er0 = Er0 * (1.0 + rng.random(Er0.shape)) + 0.5
    tdt = torch.float64 if dtype == "float64" else torch.float32
    u, Er = jnp.asarray(js.u), jnp.asarray(Er0, js.dtype)
    tu, tEr = t64(np.asarray(js.u), tdt), t64(Er0, tdt)
    L, ng = ts.layout, ts.ng
    inner = (slice(None),) + (slice(ng, -ng),) * L.dim
    for k in range(steps):
        if eager:
            with jax.disable_jit():
                u, Er, jmr, jbad = js._rad_step_impl(u, Er, dt, k * dt)[:4]
        else:
            u, Er, jmr, jbad = js._jit_rad_step(u, Er, dt, k * dt)[:4]
        tu, tEr, tmr, tbad = ts._rad_step_impl(tu, tEr, dt, k * dt)[:4]
        assert not bool(jbad) and not bool(tbad)
        close(tu[inner], np.asarray(u)[inner], dtype, f"u after step {k + 1}",
              vectors=[(L.UMX, L.UMY, L.UMZ)])
        close(tEr if tEr.dim() > L.dim else tEr[None],
              np.asarray(Er) if np.ndim(Er) > L.dim else np.asarray(Er)[None], dtype,
              f"Er after step {k + 1}")
    return js, ts


@pytest.mark.parametrize("case", ["ctu", "ctu-4groups-compton", "split", "split-4groups",
                                  "do_hydro=0"])
def test_rad_step_1d(jit_jax_solve, case):
    kw = dict(ctu={}, split=dict(split=1), **{"ctu-4groups-compton": dict(ngroups=4),
                                              "split-4groups": dict(ngroups=4, split=1),
                                              "do_hydro=0": dict(do_hydro=0)})[case]
    steps_against_jax(box_params(JParams, (32,), **kw), box_params(Params, (32,), **kw))
