"""massive_star in 1D spherical geometry (aprox19 with the NSE bypass,
Helmholtz, MonopoleGrav, the sponge) in the port against the JAX package
on the CPU, float64: the initial state from one 96-shell model given to
both, and one whole step (both Strang burns and their NSE bypass) from the
JAX initial state, within 1e-8 (`step_pair`). The domain is cut to 4e8 cm
(16 zones of 2.5e7 cm) so that the innermost zones lie in the iron core,
past the NSE thresholds; the step is 0.002 of the CFL step, as the burner
integrates the NSE zones too (as in JAX) and takes some 60 substeps there
on the second half burn (~0.4 s each on a CPU). The check of
tests/test_science_problems2.py, an iron-group core after the steps, is
made at its size (n = 96) on the card, where the burner's substeps at the
core cost seconds and not minutes (chip_smoke.py, path K).
"""

import jax
import numpy as np
import pytest
import torch

from castro_tpu.driver.sim import Simulation as JSimulation
from castro_tpu.problems import massive_star as j_ms
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import massive_star
from test_torch_science_setups import same_state, step_pair

jax.config.update("jax_enable_x64", True)

N = 16
R = 4.0e8


def params(mod):
    return mod.make_params(n=N).with_ns("geometry", prob_hi=(R, 1.0, 1.0))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_massive_star_1d_step_with_nse_matches_jax():
    sim = Simulation(params(massive_star), device="cpu",
                     problem_init=lambda s, u: massive_star.problem_init(s, u, model=model))
    assert sim.reactor is not None and sim.reactor.nse is not None
    model = massive_star.build_model(sim, nshell=96)
    js = JSimulation(params(j_ms),
                     problem_init=lambda s, u: j_ms.problem_init(s, u, model=model))
    from test_torch_hse_fills import jitted_eos

    with jitted_eos(js.eos):
        js.init_data()
    sim.init_data()
    same_state(sim.u.numpy(), np.asarray(js.u))
    dt = float(sim._estdt_impl(sim.u)) * 0.002
    L = sim.layout
    u0 = sim.interior().numpy()
    nse = sim.params.network
    core = (u0[L.UTEMP] >= nse.T_nse) & (u0[L.URHO] >= nse.rho_nse)
    assert core[0] and not core.all()
    ui = sim.interior(step_pair(js, sim, np.asarray(js.u), dt)).numpy()
    X = ui[L.UFS:L.UFS + L.nspec] / ui[L.URHO]
    np.testing.assert_allclose(X.sum(0), 1.0, rtol=1e-10)
    assert not np.allclose(X[:, core], u0[L.UFS:L.UFS + L.nspec, core] / u0[L.URHO, core])
