"""subchandra in 1D spherical geometry (subch, Helmholtz, MonopoleGrav, the
sponge) in the port against the JAX package on the CPU, float64: the
initial state from one 48-shell model given to both, and one whole step
(the two Strang burns included) from the JAX initial state, within 1e-8
(`step_pair`); then the checks of tests/test_science_problems.py on the
port's own steps: the core stays near HSE, the shell's perturbation
survives.
"""

import jax
import numpy as np
import pytest
import torch

from castro_tpu.driver.sim import Simulation as JSimulation
from castro_tpu.problems import subchandra as j_sub
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import subchandra
from castro_tpu_torch.utils import constants as C
from test_torch_science_setups import run_port, same_state, step_pair

jax.config.update("jax_enable_x64", True)

KW = dict(M_WD=0.9 * C.M_solar, M_He=0.05 * C.M_solar, pert_temp_factor=25.0)
N = 32


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_subchandra_1d_step_matches_jax():
    sim = Simulation(subchandra.make_params(dim=1, n=N, **KW), device="cpu",
                     problem_init=lambda s, u: subchandra.problem_init(s, u, model=model))
    model = subchandra.build_model(sim, nshell=48)
    js = JSimulation(j_sub.make_params(dim=1, n=N, **KW),
                     problem_init=lambda s, u: j_sub.problem_init(s, u, model=model))
    from test_torch_hse_fills import jitted_eos

    with jitted_eos(js.eos):
        js.init_data()
    sim.init_data()
    same_state(sim.u.numpy(), np.asarray(js.u))
    dt = float(sim._estdt_impl(sim.u)) * 0.5
    assert dt == pytest.approx(float(js._estdt_impl(js.u)) * 0.5, rel=1e-10)
    step_pair(js, sim, np.asarray(js.u), dt)
    L = sim.layout
    T0max = sim.interior().numpy()[L.UTEMP].max()
    ui = run_port(sim, 3)
    vcore = np.abs(ui[L.UMX] / ui[L.URHO])[:N // 4]
    assert vcore.max() < 3e7, vcore.max()
    assert ui[L.UTEMP].max() > 0.8 * T0max
