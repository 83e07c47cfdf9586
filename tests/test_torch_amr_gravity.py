"""Composite gravity on two levels (`castro_tpu_torch/driver/amr.py`) against
the JAX package's AMR driver, float64 on the CPU: tests/
test_composite_gravity.py's blob in 2D (32^2 + one level, PoissonGrav with
order-4 multipole BCs, a window inside the domain). At the initial
hierarchy: `_window_face_bc` (the coarse-interpolated Dirichlet faces),
the window's level solve with them, `_phi_flux_register` and
`_solve_phi_sync` with `phi_sync_resid`; then three coarse steps
(subcycled windows stepping with the midpoint Dirichlet data, refluxing,
avgDown), the hierarchy after each. tests/test_torch_amr_gravity_checks.py
holds the port alone to test_composite_gravity.py's thresholds.

The JAX run is op by op under disable_jit with its multigrid jitted
(tests/test_torch_gravity.py:make_jit_poisson), once for the module.

Tolerances: phi, its face data and the register within 1e-10 of their
largest magnitude; the states as tests/test_torch_amr.py holds them (1e-10
with its momentum floor), windows and masks equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from castro_tpu.config import Params as JParams
from castro_tpu.driver.amr import AmrSimulation as JAmr
from castro_tpu.problems.util import fill_from_prim as jfill
from castro_tpu.solvers import multigrid as jmg

from castro_tpu_torch.config import Params
from castro_tpu_torch.driver.amr import AmrSimulation
from castro_tpu_torch.problems.util import fill_from_prim

from test_torch_amr import _few_threads, assert_same_hierarchy  # noqa: F401
from test_torch_gravity import make_jit_poisson

jax.config.update("jax_enable_x64", True)

N = 32
DT = 1e-3
STEPS = 3


def grav_params(P, n=N, dim=2, dtype="float64"):
    """tests/test_composite_gravity.py:_mk with max_level=1 (regrid_int 2,
    tags where rho > 0.5)."""
    p = P()
    p = p.with_ns("amr", n_cell=(n,) * dim, max_level=1, regrid_int=2,
                  refinement_indicators=("dens",))
    p = p.with_ns("geometry", prob_lo=(-1.0,) * 3, prob_hi=(1.0,) * 3)
    p = p.with_ns("castro", lo_bc=(2,) * dim, hi_bc=(2,) * dim, do_grav=1, small_dens=1e-8)
    p = p.with_ns("gravity", gravity_type="PoissonGrav", max_multipole_order=4)
    p = p.replace(extra={"amr.dens.field": "density", "amr.dens.value_greater": 0.5})
    return p.with_ns("tpu", dtype=dtype)


def jax_blob(sim, u):
    r = sim.geom.radius(sim.ng, center=(0.0,) * sim.geom.dim)
    return jfill(sim, u, 0.01 + 2.0 * jnp.exp(-(r / 0.25) ** 2), (0.0, 0.0, 0.0), p=1.0)


def blob(sim, u):
    r = sim.geom.radius(sim.ng, center=(0.0,) * sim.geom.dim)
    return fill_from_prim(sim, u, 0.01 + 2.0 * torch.exp(-(r / 0.25) ** 2), (0.0, 0.0, 0.0),
                          p=1.0)


def _composite_parts(amr, conv):
    """phi at level 0, the window's face data from it, the window's phi with
    them, the flux register, the synced phi and its residual."""
    phi_c = amr._solve_phi(0, amr.u[0])
    bc = amr._window_face_bc(1, phi_c)
    amr._cur_grav_bc[1] = bc
    phi_f = amr._solve_phi(1, amr.u[1])
    reg = amr._phi_flux_register(0, phi_c, phi_f)
    sync = amr._solve_phi_sync(0, amr.u[0])
    del amr._cur_grav_bc[1]
    return dict(phi_c=conv(phi_c), bc=[conv(v) for side in bc for v in side],
                phi_f=conv(phi_f), register=conv(reg), sync=conv(sync),
                resid=amr.phi_sync_resid)


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    mp.setattr(jmg, "poisson", make_jit_poisson())
    try:
        with jax.disable_jit():
            jamr = JAmr(grav_params(JParams), problem_init=jax_blob)
            jamr.init_data()
            jparts = _composite_parts(jamr, np.asarray)
            port = AmrSimulation(grav_params(Params), problem_init=blob, device="cpu")
            port.init_data()
            pparts = _composite_parts(port, lambda t: t.numpy())
            assert_same_hierarchy(port, jamr, what="init")
            steps = []
            for k in range(STEPS):
                jamr.advance(DT)
                port.advance(DT)
                try:
                    assert_same_hierarchy(port, jamr, what=f"after coarse step {k + 1}")
                    steps.append(None)
                except AssertionError as e:
                    steps.append(e)
                    break
    finally:
        mp.undo()
    return dict(jax=jparts, port=pparts, steps=steps, port_amr=port, jax_amr=jamr)


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max() / scale if scale > 0 else np.abs(got).max()
    assert err <= 1e-10, (what, err)


def test_window_interior_and_level_solve(runs):
    """The window lies inside the domain (its faces are coarse-fine
    interfaces), and its phi solved with the interpolated faces agrees."""
    ilo, shape = runs["port_amr"].window[1]
    assert min(ilo) > 0 and max(int(ilo[k]) + shape[k] for k in range(2)) < 2 * N
    _close(runs["port"]["phi_c"], runs["jax"]["phi_c"], "level-0 phi")
    _close(runs["port"]["phi_f"], runs["jax"]["phi_f"], "window phi")


def test_window_face_bc_matches_jax(runs):
    """map_coordinates(order=1, mode='nearest') written out."""
    for k, (g, r) in enumerate(zip(runs["port"]["bc"], runs["jax"]["bc"])):
        _close(g, r, f"face {k}")


def test_phi_flux_register_matches_jax(runs):
    reg = runs["jax"]["register"]
    assert np.abs(reg).max() > 0.0
    _close(runs["port"]["register"], reg, "grad-phi flux register")


def test_solve_phi_sync_matches_jax(runs):
    _close(runs["port"]["sync"], runs["jax"]["sync"], "synced phi")
    rj, rp = runs["jax"]["resid"], runs["port"]["resid"]
    assert rj > 0.0 and abs(rp - rj) <= 1e-10 * rj, (rp, rj)


@pytest.mark.parametrize("step", range(STEPS))
def test_coarse_steps_match_jax(runs, step):
    assert len(runs["steps"]) > step, "an earlier coarse step disagreed"
    if runs["steps"][step] is not None:
        raise runs["steps"][step]
