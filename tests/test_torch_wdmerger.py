"""wdmerger in 2D RZ (PoissonGrav with multipole order 6, Helmholtz, the
sponge) in the port against the JAX package on the CPU, float64: the
head-on collision (problem 0) through one step from the JAX initial state
within 1e-8 (`step_pair`; the JAX multigrid jitted,
tests/test_torch_gravity.py:make_jit_poisson), then the checks of
tests/test_science_problems2.py (two stars approaching); the rotating
circular binary (problem 1) through steps in the port. Two 0.5 Msun
stars of 40 shells each on 16 x 32 zones.
"""

import jax
import numpy as np
import pytest
import torch

import castro_tpu.solvers.multigrid as jmg
from castro_tpu.driver.sim import Simulation as JSimulation
from castro_tpu.problems import wdmerger as j_wdm
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import wdmerger
from test_torch_gravity import make_jit_poisson
from test_torch_hse_fills import jitted_eos
from test_torch_science_setups import run_port, same_state, step_pair

jax.config.update("jax_enable_x64", True)

N = (16, 32)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _pair(problem, monkeypatch):
    kw = dict(mass_P=0.5, mass_S=0.5, problem=problem)
    sim = Simulation(wdmerger.make_params(n=N, **kw), device="cpu",
                     problem_init=lambda s, u: wdmerger.problem_init(s, u, models=models))
    models = wdmerger._wd(sim, 0.5, 1e7, nshell=40) * 2
    sim.init_data()
    js = JSimulation(j_wdm.make_params(n=N, **kw), problem_init=j_wdm.problem_init)
    monkeypatch.setattr(j_wdm, "_wd", lambda s, m, T: models[:2])
    monkeypatch.setattr(jmg, "poisson", make_jit_poisson())
    with jitted_eos(js.eos):
        js.init_data()
    same_state(sim.u.numpy(), np.asarray(js.u))
    return js, sim


def test_wdmerger_collision_step_matches_jax(monkeypatch):
    js, sim = _pair(0, monkeypatch)
    L = sim.layout
    rho0 = sim.interior().numpy()[L.URHO]
    nz = rho0.shape[1]
    assert rho0[:, :nz // 2].max() > 1e5 and rho0[:, nz // 2:].max() > 1e5
    vy0 = sim.interior().numpy()[L.UMY] / rho0
    dense = rho0 > 1e3
    low = np.arange(nz)[None, :] < nz // 2
    assert vy0[dense & low].mean() > 1e7 and vy0[dense & ~low].mean() < -1e7
    dt = float(sim._estdt_impl(sim.u)) * 0.5
    step_pair(js, sim, np.asarray(js.u), dt)
    run_port(sim, 2)


def test_wdmerger_circular_binary_steps(monkeypatch):
    js, sim = _pair(1, monkeypatch)
    assert sim.params.castro.do_rotation == 1
    L = sim.layout
    ui = run_port(sim, 2)
    assert ui[L.URHO].max() > 1e5
