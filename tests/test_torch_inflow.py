"""Inflow boundaries with the `problem_fill` hook, double Mach reflection
and the acoustic pulse, against the JAX package on the CPU.

- the ghost fill with a time-dependent hook (double Mach reflection's
  moving shock at t > 0) and a hook of one argument;
- double Mach reflection (Woodward & Colella; reference
  Exec/hydro_tests/double_mach_reflection, HLLC) and the 2D acoustic pulse,
  steps of the port's kernel structure (plain versions on the CPU) against
  the JAX XLA path, float64 and float32;
- the checks of tests/test_double_mach.py on the port's own run (128 x 32
  to t = 0.05);
- with a hook a 3D step keeps prim_aux without the Courant fold and takes
  the torch-op clean + fill, and gives the same state;
- a restart from a JAX checkpoint of a DMR run, one step matched.

Tolerances as the other test_torch_* files: float64 rtol 1e-10 (plus 1e-10
of each component's largest magnitude); float32 rtol = atol = 2e-5
(tests/test_pallas.py:41); interiors only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from castro_tpu.driver import io as jio
from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.ops.fill import fill_ghosts as j_fill_ghosts
from castro_tpu.problems import acoustic_pulse as jpulse
from castro_tpu.problems import double_mach as jdmr

from castro_tpu_torch import convert
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.ops.fill import fill_ghosts
from castro_tpu_torch.problems import acoustic_pulse, double_mach, sedov

from test_torch_hydro_paths import _assert_close, _few_threads  # noqa: F401
from test_torch_plm import calls, jax_states, port_matches, step_calls  # noqa: F401

# 16 x 16 cells: the grown shape of the 16^2 acoustic pulse, whose compiled
# JAX operations the DMR steps then share
DMR_N = (16, 16)


def test_fill_with_time_dependent_hook_matches_jax():
    """The DMR hook at t = 0.02 over a random state: the x-lo post-shock
    inflow, the moving shock on y-hi, the wall / inflow split of y-lo."""
    with jax.disable_jit():
        js = jdmr.build(n=DMR_N)
    sim = double_mach.build(n=DMR_N, device="cpu")
    rng = np.random.default_rng(0)
    u = rng.uniform(0.5, 2.0, (sim.layout.NVAR,) + sim.grown_shape())
    ref = j_fill_ghosts(jnp.asarray(u), js.layout, (2, 2), (2, 2), js.ng,
                        problem_fill=js.problem_fill, t=0.02)
    got = fill_ghosts(torch.as_tensor(u), sim.layout, (2, 2), (2, 2), sim.ng,
                      problem_fill=sim.problem_fill, t=0.02)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # a hook of one argument is called without t
    one = fill_ghosts(torch.as_tensor(u), sim.layout, (2, 2), (2, 2), sim.ng,
                      problem_fill=lambda v: 2.0 * v)
    two = fill_ghosts(torch.as_tensor(u), sim.layout, (2, 2), (2, 2), sim.ng)
    np.testing.assert_array_equal(one.numpy(), 2.0 * two.numpy())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dmr_steps_match_jax(dtype):
    dt = 1e-3
    states = jax_states(lambda: jdmr.build(n=DMR_N, dtype=dtype), dtype, 3, dt)
    port_matches(double_mach.build(n=DMR_N, dtype=dtype, device="cpu"), states, dtype, dt)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_acoustic_pulse_steps_match_jax(dtype):
    dt = 4e-3
    states = jax_states(lambda: JSim(jpulse.make_params(n=16, dtype=dtype),
                                     problem_init=jpulse.problem_init), dtype, 3, dt)
    sim = Simulation(acoustic_pulse.make_params(n=16, dtype=dtype),
                     problem_init=acoustic_pulse.problem_init, device="cpu")
    port_matches(sim, states, dtype, dt)


def test_dmr_kernel_structure(calls):
    """A DMR step calls cmpflx twice and trans_cmpflx twice, as every 2D
    Cartesian step with HLLC does."""
    assert step_calls(double_mach.build(n=DMR_N, device="cpu"), calls) == {
        "cmpflx": 2, "trans_cmpflx": 2}


def test_dmr_shock_tracks_analytic_and_stem_forms():
    """tests/test_double_mach.py on the port: the Mach stem compresses above
    the post-shock density 8, the incident shock on the top row follows the
    analytic trajectory within 4 cells, the pre-shock corner is untouched."""
    sim = double_mach.build(n=(128, 32), device="cpu")
    sim.init_data()
    sim.run(stop_time=0.05, verbose=False)
    L = sim.layout
    rho = sim.interior()[L.URHO].numpy()
    assert np.all(np.isfinite(rho))
    assert rho.max() > 12.0, rho.max()
    x = sim.geom.cell_centers_1d(0, 0).numpy()
    xs_num = x[np.argmax(np.abs(np.diff(rho[:, -1])))]
    xs_ana = 1 / 6 + 1.0 / np.tan(np.pi / 3) + (10 / np.sin(np.pi / 3)) * sim.t
    assert abs(xs_num - xs_ana) < 4 * (4.0 / 128), (xs_num, xs_ana)
    assert np.isclose(rho[-1, 0], 1.4, rtol=1e-6)


def test_hook_in_3d_takes_the_torch_clean_fill(calls):
    """With a fill hook the 3D step keeps the kernel structure but computes
    the Courant number over the interior and cleans and fills with torch
    ops (castro_tpu/driver/sim.py:523-525, :578-602); an identity hook
    leaves the state as the run without one."""
    p = sedov.make_params(n=8, dim=3, r_init=0.2, dtype="float64")
    plain = Simulation(p, problem_init=sedov.problem_init, device="cpu")
    hooked = Simulation(p, problem_init=sedov.problem_init, device="cpu",
                        problem_fill=lambda u, t: u)
    assert step_calls(hooked, calls) == {"prim_aux": 1, "flatten": 1, "trace_ppm": 3,
                                         "ctu_face": 6}
    out = []
    for sim in (plain, hooked):
        sim.init_data()
        out.append(sim._step_impl(sim.u, 2e-3)[0])
    np.testing.assert_array_equal(out[0].numpy(), out[1].numpy())


def test_restart_from_jax_dmr_checkpoint(tmp_path):
    """One step of the port from a JAX DMR checkpoint (t > 0, so the moving
    inflow is not at its initial place) matches the JAX step."""
    with jax.disable_jit():
        js = jdmr.build(n=DMR_N)
        js.init_data()
        js.run(max_step=2, verbose=False)
        path = jio.write_checkpoint(js, str(tmp_path / "chk00002"))
        js.run(max_step=3, verbose=False)
        ref = np.asarray(js.interior())
    sim = double_mach.build(n=DMR_N, device="cpu")
    convert.restart_from_jax_checkpoint(sim, path)
    assert sim.step_count == 2 and sim.t > 0.0
    sim.run(max_step=3, verbose=False)
    _assert_close(sim.interior(), ref, "float64", "one step after the restart")
