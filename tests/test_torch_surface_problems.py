"""The surface-burning setups xrb_mixed (rprox), nova (the nova network)
and reacting_bubble (aprox13), all with the Helmholtz EOS and constant
gravity, in the port against the JAX package on the CPU, float64, at
small sizes: the initial state (toy_atm or the plane-parallel HSE
generator, the seed vortices, the bubbles), the step's dt, and one step of
everything but the Strang burns, from the JAX initial state. The burns
are off on both sides: the JAX package's burner compiles for 20-40 s a
network on a CPU, so each network's burn is held on its own
(test_torch_burn_surface.py, test_torch_flame_wave_burn.py). The JAX
step runs op by op with its EOS modes jitted (`jitted_eos`).

Tolerances: the initial state and dt within 1e-10 relative (each
component's largest magnitude as the floor); the step within 1e-10
|jax| + 1e-12 max|jax| per component, interiors only, the three momenta
sharing the largest momentum magnitude as their floor (reacting_bubble's
x momentum is a cancelling difference of face pressures of 4e26 in an
atmosphere uniform in x but for its bubbles: its smaller values are
rounding, some 1e-14 of the y momentum).
"""

import jax
import numpy as np
import pytest
import torch

from castro_tpu.driver.sim import Simulation as JSimulation
from castro_tpu.problems import nova as j_nova
from castro_tpu.problems import reacting_bubble as j_reacting_bubble
from castro_tpu.problems import xrb_mixed as j_xrb_mixed
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import nova, reacting_bubble, xrb_mixed
from test_torch_hse_fills import jitted_eos

jax.config.update("jax_enable_x64", True)

RTOL = 1e-10
# name: (jax module, port module, grid, its network's species)
PROBLEMS = {"xrb_mixed": (j_xrb_mixed, xrb_mixed, (8, 24), 10),
            "nova": (j_nova, nova, (8, 16), 14),
            "reacting_bubble": (j_reacting_bubble, reacting_bubble, (12, 20), 13)}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_init_and_step_match_jax(name):
    jmod, tmod, n, nspec = PROBLEMS[name]
    js = JSimulation(jmod.make_params(n=n), problem_init=jmod.problem_init)
    with jitted_eos(js.eos):
        js.init_data()
    sim = Simulation(tmod.make_params(n=n), problem_init=tmod.problem_init, device="cpu")
    sim.init_data()
    L = sim.layout
    assert L.nspec == nspec and sim.reactor is not None
    ref0 = np.asarray(js.u)
    scale = np.abs(ref0).reshape(L.NVAR, -1).max(1)[:, None, None]
    err = np.abs(sim.u.numpy() - ref0) - (RTOL * np.abs(ref0) + 1e-14 * scale)
    assert err.max() <= 0.0, ("init", np.unravel_index(np.argmax(err), err.shape))
    dt = float(js._jit_estdt(js.u))
    assert float(sim._estdt_impl(sim.u)) == pytest.approx(dt, rel=RTOL)

    js.reactor, sim.reactor = None, None
    with jitted_eos(js.eos):
        ju, _, bad = js._step_impl(js.u, dt, 0.0)
    tu, _, flag = sim._step_impl(torch.tensor(ref0), dt, 0.0)
    assert not bool(bad) and not bool(flag)
    ref, got = np.asarray(js.interior(ju)), sim.interior(tu).numpy()
    scale = np.abs(ref).reshape(L.NVAR, -1).max(1)[:, None, None]
    mom = slice(L.UMX, L.UMZ + 1)
    scale[mom] = scale[mom].max()
    err = np.abs(got - ref) - (RTOL * np.abs(ref) + 1e-12 * scale)
    assert err.max() <= 0.0, ("step", np.unravel_index(np.argmax(err), err.shape))
    assert np.abs(got[L.UMY]).max() > 0.0
