"""Steps with gravity and the sponge, the port on the CPU against the JAX
package, both from the JAX initial state with the same dt: 1D spherical
DustCollapse (monopole gravity) with `grav_source_type` 1-4, with the
sponge (density and pressure bands, implicit and explicit), with
`source_term_predictor=1`, and in float32 against the JAX kernel route
(cmpflx_pallas under the Pallas interpreter); 3D Cartesian DustCollapse
(Poisson gravity, multipole BCs) in tests/test_torch_gravity_steps_3d.py.

The JAX step runs op by op under disable_jit, its multigrid jitted
(tests/test_torch_gravity.py:make_jit_poisson).

Tolerances: float64 1e-10 |jax| + 1e-10 max|jax| per component
(tests/test_torch_hydro_paths.py:_assert_close); float32 against the
kernel route 2e-5 |jax| + 2e-5 max|jax| per component (2e-5 is
tests/test_pallas.py:41's budget; the floor per component is
chip_smoke.py's card-vs-CPU form: e = E - KE of the cold collapse cancels
in float32, and e and T differ by up to 3e-3 of themselves, 1.3e-5 of their
largest magnitude, where everything else agrees within 1e-6). The collapse's
energy is kinetic: e is 1e-14 of E, so the float64 comparison leaves out
nothing but is sharp (JAX's own jitted and op-by-op steps differ by 1e-10
of max|E| and 1.5e-8 of max|e| here, from that cancellation; the port
sits within 1e-10 of the op-by-op one).
"""

import numpy as np
import pytest

import jax

from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.ops import pallas_kernels as pk
from castro_tpu.problems import dust_collapse as jdc
from castro_tpu.solvers import multigrid as jmg

from castro_tpu_torch import convert
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import dust_collapse

from test_torch_gravity import make_jit_poisson
from test_torch_hydro_paths import _assert_close, _few_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

N1 = 64
DT = 2e-4
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def jit_jax_poisson():
    mp = pytest.MonkeyPatch()
    mp.setattr(jmg, "poisson", make_jit_poisson())
    yield
    mp.undo()


def _jax_steps(params, steps, dt, use_pallas=False, dtype="float64"):
    """The JAX states [initial, after each step] as numpy; with
    source_term_predictor=1 the lagged dS/dt carried from step to step."""
    with jax.disable_jit():
        js = JSim(params, problem_init=jdc.problem_init)
        if use_pallas:
            js.cfg = js.cfg._replace(use_pallas=True)
        js.init_data()
        states = [np.asarray(js.u)]
        pred = None
        stp = params.castro.source_term_predictor == 1
        for k in range(steps):
            kw = dict(src_pred=pred) if stp else {}
            out = js._step_impl(js.u, np.dtype(dtype).type(dt), k * dt, **kw)
            assert not bool(out[2])
            js.u = out[0]
            if stp:
                pred = out[-1]
            states.append(np.asarray(js.u))
    return states


def _port_steps(params, states, dt, dtype="float64"):
    sim = Simulation(params, problem_init=dust_collapse.problem_init, device="cpu")
    sim.init_data()
    ng, dim = sim.ng, sim.layout.dim
    inner = (slice(None),) + (slice(ng, -ng),) * dim
    if dtype == "float64":
        # the sphere's tanh edge: 1 - tanh(x) far outside it is a few ulp
        # of tanh, which XLA and torch round differently, times rho_0 = 1e9:
        # the ambient density (1) differs by 1e-7, and so does its
        # temperature, the largest of the grid; the rest to the bound
        L = sim.layout
        own, ref = sim.interior().numpy(), states[0][inner]
        keep = [c for c in range(L.NVAR) if c != L.UTEMP]
        _assert_close(own[keep], ref[keep], dtype, "init")
        np.testing.assert_allclose(own[L.UTEMP], ref[L.UTEMP], rtol=1e-6)
    u = convert.state_from_numpy(states[0], sim.layout, "cpu", sim.dtype)
    pred = None
    stp = params.castro.source_term_predictor == 1
    for k in range(len(states) - 1):
        out = sim._step_impl(u, dt, k * dt, src_pred=pred)
        u, min_rho, bad = out[:3]
        assert not bool(bad) and float(min_rho) > 0.0
        if stp:
            pred = out[-1]
        got, ref = sim.interior(u).double().numpy(), states[k + 1][inner].astype(np.float64)
        if dtype == "float64":
            _assert_close(got, ref, dtype, f"step {k + 1}")
        else:
            floor = 2e-5 * np.abs(ref).reshape(ref.shape[0], -1).max(1)
            np.testing.assert_array_less(
                np.abs(got - ref), 2e-5 * np.abs(ref) + floor[:, None] + 1e-300,
                err_msg=f"step {k + 1}")
    return sim


def _params(mod, dtype="float64", **castro):
    return mod.make_params(n=N1, dim=1, dtype=dtype).with_ns("castro", **castro)


@pytest.mark.parametrize("gst", [1, 2, 3, 4])
def test_dust_collapse_1d_matches_jax(gst):
    """1D spherical DustCollapse, monopole gravity, each grav_source_type
    (4, the default, folds the edge mass fluxes); two gravity fields a
    step, the old state's memoized for the corrector."""
    states = _jax_steps(_params(jdc, grav_source_type=gst), STEPS, DT)
    sim = _port_steps(_params(dust_collapse, grav_source_type=gst), states, DT)
    src = sim.source_fns[0]
    assert src.name == "grav" and src._memo is None  # cleared at the step's end


SPONGES = {
    "density-implicit": dict(sponge_lower_density=1e2, sponge_upper_density=1e6,
                             sponge_timescale=1e-3),
    "density-explicit": dict(sponge_lower_density=1e2, sponge_upper_density=1e6,
                             sponge_implicit=0, sponge_timescale=5e-3),
    "pressure-target": dict(sponge_lower_pressure=1e3, sponge_upper_pressure=1e12,
                            sponge_target_x_velocity=1e6),
    "radius": dict(sponge_lower_radius=5e8, sponge_upper_radius=6e8,
                   sponge_timescale=2e-3),
}


@pytest.mark.parametrize("case", list(SPONGES))
def test_sponge_matches_jax(case):
    """The sponge beside gravity (the density, pressure and radius ramps,
    implicit and explicit, a target velocity; tau = dt where no timescale
    is set)."""
    kw = dict(do_sponge=1, **SPONGES[case])
    states = _jax_steps(_params(jdc, **kw), STEPS, DT)
    sim = _port_steps(_params(dust_collapse, **kw), states, DT)
    assert [fn.name for fn in sim.source_fns] == ["grav", "sponge"]


def test_source_term_predictor_with_gravity():
    """source_term_predictor=1: the lagged dS/dt of the gravity corrector
    (its dt*corr folded into the predictor's new-time term) carried over
    three steps."""
    kw = dict(source_term_predictor=1)
    states = _jax_steps(_params(jdc, **kw), 3, DT)
    _port_steps(_params(dust_collapse, **kw), states, DT)


def test_float32_kernel_route_matches_jax():
    """float32: the JAX package on its kernel route (cmpflx_pallas, 1D
    spherical) under the Pallas interpreter against the port's kernel
    structure (cmpflx's plain version on the CPU)."""
    pk.INTERPRET = True
    try:
        states = _jax_steps(_params(jdc, dtype="float32"), STEPS, DT, use_pallas=True,
                            dtype="float32")
    finally:
        pk.INTERPRET = False
    _port_steps(_params(dust_collapse, dtype="float32"), states, DT, dtype="float32")


def test_restart_from_jax_gravity_checkpoint(tmp_path):
    """A JAX checkpoint of a 1D DustCollapse run with a point mass that
    accretes (point_mass_fix_solution=1) restarts the port, which then
    steps on as JAX does: the state, t and the accreted point mass come
    from the checkpoint."""
    from castro_tpu.driver import io as jio

    kw = dict(use_point_mass=1, point_mass=1e33, point_mass_fix_solution=1)
    with jax.disable_jit():
        js = JSim(_params(jdc, **kw), problem_init=jdc.problem_init)
        js.init_data()
        for _ in range(2):
            js.advance(DT)
            js.step_count += 1
        path = jio.write_checkpoint(js, str(tmp_path / "chk00002"))
        pm_chk = js.point_mass
        for _ in range(2):
            js.advance(DT)
    assert pm_chk > 1e33
    sim = Simulation(_params(dust_collapse, **kw), problem_init=dust_collapse.problem_init,
                     device="cpu")
    convert.restart_from_jax_checkpoint(sim, path)
    assert sim.point_mass == pm_chk and sim.t == pytest.approx(2 * DT, rel=1e-14)
    for _ in range(2):
        sim.advance(DT)
    ng = sim.ng
    _assert_close(sim.interior(), np.asarray(js.u)[:, ng:-ng], "float64", "after the restart")
    assert abs(sim.point_mass - js.point_mass) <= 1e-10 * js.point_mass
