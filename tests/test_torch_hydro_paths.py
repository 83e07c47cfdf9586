"""The 2D and 1D Cartesian hydro paths end to end: steps of the port's
Simulation on the CPU against the JAX Simulation on its XLA path, for 2D
Sedov with outflow and with symmetry boundaries, with riemann_solver=1 and
with hybrid_riemann=1 over HLLC, and 1D Sod with riemann_solver 0 and 1, in
float64 and float32; the shock flag, hybrid momenta (3D) and more than one
species; the port's 1D Sod against the exact Riemann solution; and every
configuration that stays unported raising at construction.
(`tests/test_torch_hydro_paths_3d.py` holds the unfused 3D paths,
`tests/test_torch_hydro_kernel_route.py` the JAX package's kernel route.)

Both packages step from the same initial state (the JAX one, handed over
as numpy) with the same fixed dt. The JAX reference runs with jit disabled
(op by op it compiles once per shape, far faster here than compiling the
whole step). The port runs its kernel structure through the CUDA kernels'
plain versions.

Tolerances, interiors only: float64, rtol = 1e-10 with an absolute floor
of 1e-10 times the component's largest magnitude (momenta are zero up to
round-off in places); float32, rtol = atol = 2e-5, the fused-vs-XLA budget
the JAX package already accepts (tests/test_pallas.py:41).
"""

import numpy as np
import pytest
import torch

import jax

from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.problems import sedov as jsedov
from castro_tpu.problems import sod as jsod

from castro_tpu_torch import convert
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.ops import advection_util as au
from castro_tpu_torch.ops import kernels as K
from castro_tpu_torch.problems import sedov, sod
from castro_tpu_torch.state import StateLayout as StateLayoutT
from castro_tpu_torch.utils.exact_riemann import solution

# name -> (problem, dim, n, castro overrides, steps, dt)
CASES = {
    "sedov2d-outflow": ("sedov", 2, 24, dict(), 3, 2e-3),
    "sedov2d-symmetry": ("sedov", 2, 24, dict(lo_bc=(3, 3, 3), hi_bc=(3, 3, 3)), 3, 2e-3),
    "sedov2d-cg": ("sedov", 2, 24, dict(riemann_solver=1), 2, 2e-3),
    "sedov2d-hybrid-hllc": ("sedov", 2, 24, dict(hybrid_riemann=1, riemann_solver=2), 3, 2e-3),
    "sod1d": ("sod", 1, 64, dict(), 4, 2e-3),
    "sod1d-cg": ("sod", 1, 64, dict(riemann_solver=1), 4, 2e-3),
}
MODS = {"sedov": (jsedov, sedov), "sod": (jsod, sod)}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _params(mod, spec, dtype):
    """spec: a CASES entry, optionally followed by the species' names."""
    problem, dim, n, castro = spec[:4]
    if problem == "sedov":
        p = mod.make_params(n=n, dim=dim, stop_time=0.1, r_init=0.2, dtype=dtype)
    else:
        p = mod.make_params(n=n, dim=dim, dtype=dtype)
    if len(spec) > 6:
        p = p.with_ns("network", spec_names=spec[6])
    return p.with_ns("castro", **castro) if castro else p


def _assert_close(got, ref, dtype, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if dtype == "float64":
        scale = np.abs(ref).reshape(ref.shape[0], -1).max(1)
        atol = (1e-10 * scale).reshape((-1,) + (1,) * (ref.ndim - 1))
        np.testing.assert_array_less(np.abs(got - ref), 1e-10 * np.abs(ref) + atol + 1e-300,
                                     err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5, err_msg=what)


def _jax_states(spec, dtype, use_pallas=False):
    """The JAX package's states [initial, after step 1, ...] of the case
    `spec` (an entry of CASES) as numpy; `use_pallas` takes its kernel route
    (the caller sets the Pallas interpreter)."""
    problem, _, _, _, steps, dt = spec[:6]
    jmod = MODS[problem][0]
    with jax.disable_jit():
        js = JSim(_params(jmod, spec, dtype), problem_init=jmod.problem_init)
        if use_pallas:
            js.cfg = js.cfg._replace(use_pallas=True)
            js._use_fused_prim = js.layout.dim == 3
        js.init_data()
        states = [np.asarray(js.u)]
        for _ in range(steps):
            u, _, bad = js._step_impl(js.u, np.dtype(dtype).type(dt), 0.0)
            assert not bool(bad)
            js.u = u
            states.append(np.asarray(u))
    return states, js.ng


def _port_matches(spec, dtype, states, ng):
    """Step the port from states[0] and hold every step against `states`."""
    problem, dim, _, castro, steps, dt = spec[:6]
    mod = MODS[problem][1]
    sim = Simulation(_params(mod, spec, dtype), problem_init=mod.problem_init, device="cpu")
    sim.init_data()
    inner = (slice(None),) + (slice(ng, -ng),) * dim
    if dtype == "float64":
        _assert_close(sim.interior(), states[0][inner], dtype, "init")
    K.reset_launch_counts()
    u = convert.state_from_numpy(states[0], sim.layout, "cpu", sim.dtype)
    flagged = 0
    for k in range(steps):
        if castro.get("hybrid_riemann"):
            q, _ = au.ctoprim(u, sim.layout, sim.eos, sim.cfg.small_dens, sim.small_temp)
            shk = au.shock(q, sim.geom.dx, sim.layout, sim.cfg.shock_threshold)
            flagged = max(flagged, int(sim.interior(shk[None]).sum()))
        u, min_rho, bad = sim._step_impl(u, dt)
        assert not bool(bad) and float(min_rho) > 0.0
        _assert_close(sim.interior(u), states[k + 1][inner], dtype, f"step {k + 1}")
    if castro.get("hybrid_riemann"):
        assert flagged > 0  # some faces did take the HLL flux
    assert all(v == 0 for v in K.launch_counts().values())  # CPU: plain versions only


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax(case, dtype):
    states, ng = _jax_states(CASES[case], dtype)
    _port_matches(CASES[case], dtype, states, ng)


@pytest.mark.parametrize("riemann_solver", [0, 1, 2])
def test_sod_1d_against_exact(riemann_solver):
    """1D Sod (n = 128) to t = 0.2: mean density error against the exact
    solution below 0.015 of the mean density, and the star-region pressure
    within 3%, the bounds of tests/test_sod.py."""
    params = sod.make_params(n=128, dim=1).with_ns("castro", riemann_solver=riemann_solver)
    sim = Simulation(params, problem_init=sod.problem_init, device="cpu")
    sim.run(stop_time=0.2, verbose=False)
    L = sim.layout
    u = sim.interior().numpy()
    x = sim.geom.cell_centers_1d(0, 0).numpy()
    rho_ex, _, _ = solution(x, sim.t, 0.5, 1.0, 0.0, 1.0, 0.125, 0.0, 0.1, 1.4)
    assert np.abs(u[L.URHO] - rho_ex).mean() / rho_ex.mean() < 0.015
    mid = (x > 0.55) & (x < 0.65)
    assert abs((u[L.UEINT] * 0.4)[mid].mean() - 0.30313) / 0.30313 < 0.03


# layouts the kernels were once not built for, now held against JAX:
# name -> (dim, n, castro, species, steps)
UNPORTED = {
    "use_shock_var": (2, 16, dict(use_shock_var=1), ("He4", "C12", "O16"), 2),
    "hybrid-momentum": (3, 8, dict(hybrid_momentum=1, hybrid_hydro=1), ("He4", "C12", "O16"), 1),
    "nspec-2": (2, 16, {}, ("He4", "C12"), 1),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_configurations_raise(name):
    """The configurations that changed the kernels' state layout (the
    shock flag, hybrid momenta, more than one species) and raised until the
    kernels took any layout now step as the JAX package steps them: Sedov
    in float64 from the JAX initial state, the port's kernel structure
    through the plain versions, held as test_steps_match_jax holds them.
    What stays unported raises: test_still_unported_configurations_raise."""
    dim, n, castro, species, steps = UNPORTED[name]
    spec = ("sedov", dim, n, castro, steps, 2e-3, species)
    states, ng = _jax_states(spec, "float64")
    _port_matches(spec, "float64", states, ng)
    if name == "use_shock_var":
        L = StateLayoutT(dim=2, nspec=3, shock_var=True)
        shk = states[-1][(L.USHK,) + (slice(ng, -ng),) * dim]
        assert set(np.unique(shk)) <= {0.0, 1.0} and shk.max() == 1.0


STILL_UNPORTED = {
    "sdc": (dict(time_integration_method=2), dict(distribute_fine=1), "queue 1 item 13"),
}


@pytest.mark.parametrize("name", list(STILL_UNPORTED))
def test_still_unported_configurations_raise(name):
    """SDC runs on one level and on AMR; the sharded SDC step of a
    distributed hierarchy raises at construction and names its ROADMAP
    item."""
    from castro_tpu_torch.driver.amr import AmrSimulation

    castro, amr, item = STILL_UNPORTED[name]
    p = sedov.make_params(n=16, dim=1).with_ns("castro", **castro)
    Simulation(p, problem_init=sedov.problem_init, device="cpu")
    p = p.with_ns("amr", max_level=1, **amr)
    with pytest.raises(NotImplementedError, match=item + r".*ROADMAP\.md"):
        AmrSimulation(p, problem_init=sedov.problem_init, device="cpu")


FORMERLY_UNPORTED = {
    "curvilinear": (2, dict(), dict(coord_sys=1)),
    "plm": (2, dict(ppm_type=0), {}),
    "flux-limiter": (2, dict(limit_fluxes_on_small_dens=1), {}),
    "speed_limit": (1, dict(speed_limit=1.0e9), {}),
    "transverse_use_eos": (2, dict(transverse_use_eos=1), {}),
    "inflow": (1, dict(lo_bc=(1, 2, 2)), {}),
}


def test_nse_configuration_steps():
    """network.nse=1, which raised until the NSE bypass was ported
    (held against the JAX package in tests/test_torch_nse.py), constructs
    and steps."""
    p = sedov.make_params(n=8, dim=1).with_ns("castro", do_react=1).with_ns(
        "network", network_name="iso7", nse=1)
    sim = Simulation(p, problem_init=sedov.problem_init, device="cpu")
    assert sim.reactor.nse is not None
    sim.init_data()
    sim.advance(sim.estimate_dt())
    assert bool(torch.isfinite(sim.interior()).all())


@pytest.mark.parametrize("name", list(FORMERLY_UNPORTED))
def test_formerly_unported_configurations_step(name):
    """The configurations this file once held raising now construct and
    step (each is held against the JAX package in tests/test_torch_
    {curvilinear,plm,limiters,inflow}.py)."""
    dim, castro, geometry = FORMERLY_UNPORTED[name]
    p = sedov.make_params(n=8, dim=dim).with_ns("castro", **castro)
    if geometry:
        p = p.with_ns("geometry", **geometry)
    sim = Simulation(p, problem_init=sedov.problem_init, device="cpu")
    sim.init_data()
    sim.advance(sim.estimate_dt())
    assert bool(torch.isfinite(sim.interior()).all())
