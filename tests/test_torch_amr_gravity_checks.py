"""Composite gravity on two levels, the port alone on the CPU held to
tests/test_composite_gravity.py's thresholds (its 2D blob, 32^2 + one
level, against a uniformly fine 64^2 run): the window's level solve with
coarse-interpolated Dirichlet faces within 5e-3 of the uniformly fine
phi; four subcycled coarse steps whose composite density tracks the fine
run's (95th percentile of the relative difference over refined cells
< 1%); and the delta-phi sync moving the coarse phi toward the fine
truth (< 0.9 of the plain solve's error), with no drift over four steps.
The parity with the JAX driver is in tests/test_torch_amr_gravity.py.
"""

import numpy as np

from castro_tpu_torch.config import Params
from castro_tpu_torch.driver.amr import AmrSimulation
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.ops.interlevel import restrict

from test_torch_amr import _few_threads  # noqa: F401
from test_torch_amr_gravity import blob, grav_params


def _fine(dtype):
    p = grav_params(Params, n=64, dtype=dtype).with_ns("amr", max_level=0)
    sim = Simulation(p, problem_init=blob, device="cpu")
    sim.init_data()
    return sim, sim.source_fns[0].gravity


def _amr(dtype):
    amr = AmrSimulation(grav_params(Params, dtype=dtype), problem_init=blob, device="cpu")
    amr.init_data()
    assert amr._has_poisson and int(amr.masks[1].sum()) > 0
    return amr


def test_composite_level_solve_matches_uniform_fine():
    fine, grav = _fine("float32")
    rho_f = fine.interior()[fine.layout.URHO]
    phi_ref = grav._poisson(rho_f)[1].double().numpy()
    amr = _amr("float32")
    phi_c = amr._solve_phi(0, amr.u[0])
    amr._cur_grav_bc[1] = amr._window_face_bc(1, phi_c)
    phi_w = amr._solve_phi(1, amr.u[1]).double().numpy()
    ilo, shape = amr.window[1]
    ref_w = phi_ref[tuple(slice(int(ilo[k]), int(ilo[k]) + shape[k]) for k in range(2))]
    err = np.abs(phi_w - ref_w) / np.abs(ref_w).max()
    assert err.max() < 5e-3, err.max()


def test_amr_gravity_dynamics_tracks_fine():
    fine, _ = _fine("float32")
    dt = 1e-3
    u = fine.u
    for i in range(4):
        u, _, bad = fine._step_impl(u, dt, i * dt)
        assert not bool(bad)
    rho_fine = fine.interior(u)[fine.layout.URHO].double().numpy()
    amr = _amr("float32")
    for _ in range(4):
        amr.advance(dt)
    comp = amr.composite_interior()[amr.sim0.layout.URHO].double().numpy()
    ilo, shape = amr.window[1]
    m1 = np.zeros(rho_fine.shape, bool)
    m1[tuple(slice(int(ilo[k]), int(ilo[k]) + shape[k]) for k in range(2))] = \
        amr.masks[1].numpy()
    rel = np.abs(comp[m1] - rho_fine[m1]) / np.abs(rho_fine[m1])
    assert np.percentile(rel, 95) < 0.01, np.percentile(rel, 95)


def test_gravity_sync_improves_composite_phi():
    amr = _amr("float64")
    _, gf = _fine("float64")

    def fine_truth():
        rho = amr.composite_interior()[amr.sim0.layout.URHO]
        return restrict(gf._poisson(rho)[1], amr.dim, comp_axes=0).numpy()

    def errors():
        truth = fine_truth()
        scale = np.abs(truth).max()
        plain = np.abs(amr._solve_phi(0, amr.u[0]).numpy() - truth).max() / scale
        sync = np.abs(amr._solve_phi_sync(0, amr.u[0]).numpy() - truth).max() / scale
        return plain, sync

    err_plain, err_sync = errors()
    assert err_sync < 0.9 * err_plain, (err_sync, err_plain)
    assert amr.phi_sync_resid > 0.0
    for _ in range(4):
        amr.advance(amr.estimate_dt())
    e_plain2, e_sync2 = errors()
    assert e_sync2 < 1.05 * e_plain2, (e_sync2, e_plain2)
    assert e_sync2 < 2.0 * err_sync
