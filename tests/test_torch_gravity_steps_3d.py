"""3D Cartesian DustCollapse steps (Poisson gravity, multipole BCs, outflow)
of the port on the CPU (its kernel structure through the plain versions)
against the JAX package (XLA path, op by op under disable_jit, its
multigrid jitted as in tests/test_torch_gravity.py), float64, from the JAX
initial state with the same dt; and the point-mass fix with Poisson
gravity (the run-time point mass through the step context). Split from
tests/test_torch_gravity_steps.py to keep each file under a minute on one
worker.

Tolerance: 1e-10 |jax| + 1e-10 max|jax| per component.
"""

import numpy as np
import pytest

import jax

from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.problems import dust_collapse as jdc
from castro_tpu.solvers import multigrid as jmg

from castro_tpu_torch import convert
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.problems import dust_collapse

from test_torch_gravity import make_jit_poisson
from test_torch_hydro_paths import _assert_close, _few_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

N3 = 16
DT = 2e-4


@pytest.fixture(autouse=True, scope="module")
def jit_jax_poisson():
    mp = pytest.MonkeyPatch()
    mp.setattr(jmg, "poisson", make_jit_poisson())
    yield
    mp.undo()


def _pair(**castro):
    jp = jdc.make_params(n=N3, dim=3).with_ns("castro", **castro)
    tp = dust_collapse.make_params(n=N3, dim=3).with_ns("castro", **castro)
    with jax.disable_jit():
        js = JSim(jp, problem_init=jdc.problem_init)
        js.init_data()
    sim = Simulation(tp, problem_init=dust_collapse.problem_init, device="cpu")
    return js, sim


def test_dust_collapse_3d_steps_match_jax():
    """Two steps; exactly two Poisson solves a step (the old state's field
    memoized for the corrector), the same V-cycle counts as the JAX while
    loop (tests/test_torch_gravity.py holds the counts), the kernel
    structure of a step with sources (prim_aux twice, once without div u;
    clean_fill twice)."""
    js, sim = _pair()
    ng = sim.ng
    inner = (slice(None),) + (slice(ng, -ng),) * 3
    u = convert.state_from_numpy(np.asarray(js.u), sim.layout, "cpu", sim.dtype)
    ju = js.u
    grav = sim.source_fns[0].gravity
    K.reset_launch_counts()
    for k in range(2):
        with jax.disable_jit():
            ju, _, bad = js._step_impl(ju, DT, k * DT)
        assert not bool(bad)
        u, min_rho, flag = sim._step_impl(u, DT, k * DT)
        assert not bool(flag) and float(min_rho) > 0.0
        _assert_close(sim.interior(u), np.asarray(ju)[inner], "float64", f"step {k + 1}")
        assert len(grav.solve_stats) == 2 * (k + 1)
    assert all(1 < v < grav.n_vcycles for v, _ in grav.solve_stats)
    # on the CPU the wrappers run their plain versions and count nothing;
    # the structure is the kernel route's (chip_smoke.py path I counts it)
    assert sim._kernel_prim and sim._kernel_clean_fill
    assert all(v == 0 for v in K.launch_counts().values())


def test_point_mass_fix_with_poisson_gravity():
    """use_point_mass with point_mass_fix_solution=1: the run-time point
    mass reaches gravity through the step context, one try_step each."""
    kw = dict(use_point_mass=1, point_mass=1e33, point_mass_fix_solution=1)
    js, sim = _pair(**kw)
    sim.u = convert.state_from_numpy(np.asarray(js.u), sim.layout, "cpu", sim.dtype)
    with jax.disable_jit():
        for _ in range(2):
            ju, status = js.try_step(DT)
            assert status.success
            js.u = ju
            js.t += DT
    for _ in range(2):
        u_new, status = sim.try_step(DT)
        assert status.success
        sim.u = u_new
        sim.t += DT
    ng = sim.ng
    inner = (slice(None),) + (slice(ng, -ng),) * 3
    _assert_close(sim.interior(), np.asarray(js.u)[inner], "float64", "after two steps")
    assert abs(sim.point_mass - js.point_mass) <= 1e-10 * js.point_mass
    assert sim.point_mass > 1e33  # the centre accreted
