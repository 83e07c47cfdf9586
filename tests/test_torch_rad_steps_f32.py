"""Radiation steps in float32 of the port against the JAX package's from
the same state with the same dt (tests/test_torch_rad_steps.py:
steps_against_jax): the 1D rad-CTU box, and tests/test_f32_physics.py's
multigroup configuration (a hot spot, 4 groups, f-space advection) with
Compton scattering on, in 2D. The guards of the JAX package hold: the
normalized flux direction of the comoving terms, the dtype-aware f-space
guard, the photon-number rescale skipped in empty zones. float32 solves
stall above rtol 1e-6 and run their cap, in both packages. Tolerance
rtol = atol = 2e-5."""

import jax.numpy as jnp

from castro_tpu.config import Params as JParams
from castro_tpu.problems.util import fill_from_prim as jfill

from castro_tpu_torch.config import Params

from test_torch_radiation import _few_threads, jit_jax_solve  # noqa: F401
from test_torch_rad_steps import box_params, steps_against_jax


def test_rad_step_1d_float32(jit_jax_solve):
    kw = dict(dtype="float32")
    steps_against_jax(box_params(JParams, (32,), **kw), box_params(Params, (32,), **kw),
                      dtype="float32")


def _mg(P):
    p = P().with_ns("amr", n_cell=(16, 16))
    p = p.with_ns("geometry", prob_lo=(0.0,) * 3, prob_hi=(1.0,) * 3)
    p = p.with_ns("castro", do_radiation=1, do_hydro=1, lo_bc=(0, 0), hi_bc=(0, 0))
    p = p.with_ns("radiation", ngroups=4, const_kappa_p=1e-6, const_kappa_r=50.0, limiter=0,
                  lowest_group_hz=1e14, highest_group_hz=1e18, do_inelastic_scattering=1)
    return p.with_ns("tpu", dtype="float32")


def _jinit(sim, u):
    r = sim.geom.radius(sim.ng, center=(0.5, 0.5))
    return jfill(sim, u, 1.0, (0.0, 0.0, 0.0), T=0.1 + 1.0 * jnp.exp(-(r / 0.12) ** 2))


def test_multigroup_rad_ctu_float32(jit_jax_solve):
    steps_against_jax(_mg(JParams), _mg(Params), dt=2e-7, jinit=_jinit, er=lambda s_: s_.u_rad,
                      dtype="float32", eager=True)
