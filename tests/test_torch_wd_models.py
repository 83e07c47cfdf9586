"""The spherical models of the white-dwarf and massive-star setups in the
port against the JAX package on the CPU, float64: `wd_model_for_mass`'s
batched walk of the bisection tree (the sequence of midpoints of the
sequential bisection, several tree levels a march), and the models and
initial states of subchandra, massive_star and wdmerger (problems 0 and 1)
at small shell counts and grids.

Tolerances: model columns within 1e-10 relative (the marches keep the
JAX package's 16 Newton iterations a shell), initial states within 1e-10
relative with each component's largest magnitude as the floor.
"""

import jax
import numpy as np
import pytest
import torch

from castro_tpu.driver.sim import Simulation as JSimulation
from castro_tpu.problems import massive_star as j_ms
from castro_tpu.problems import subchandra as j_sub
from castro_tpu.problems import wdmerger as j_wdm
from castro_tpu.utils import initial_models as jim
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import massive_star, subchandra, wdmerger
from castro_tpu_torch.utils import constants as C
from castro_tpu_torch.utils import initial_models as tim
from test_torch_hse_fills import jitted_eos
from test_torch_initial_models import _wd_callbacks, eoses  # noqa: F401
from test_torch_science_setups import same_state

jax.config.update("jax_enable_x64", True)

RTOL = 1e-10


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _same_model(got, ref, keys):
    for k in keys:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=RTOL, atol=0, err_msg=k)


@pytest.mark.parametrize("iters,levels,marches", [(4, None, 1), (7, 3, 3)])
def test_batched_walk_matches_jax(eoses, iters, levels, marches):  # noqa: F811
    """The shells and iterations of test_torch_initial_models.py's
    sequential walk; then seven bisection steps through trees of three
    levels (three marches: 3 + 3 + 1 levels)."""
    M = 0.9 * 1.989e33
    r = np.linspace(1.5e7, 1.2e9, 32)
    jx, jT = _wd_callbacks("jax", 0.8 * 1.989e33)
    tx, tT = _wd_callbacks("torch", 0.8 * 1.989e33)
    kw = dict(rho_c_lo=1e6, rho_c_hi=1e8, iters=iters, rho_cutoff=1e3)
    ref = jim.wd_model_for_mass(eoses["aprox13"][0], r, M, 1e8, jx, T_of_rho=jT, **kw)
    got = tim.wd_model_for_mass(eoses["aprox13"][1], r, M, 1e8, tx, T_of_rho=tT, levels=levels,
                                **kw)
    assert got["marches"] == marches
    # the last midpoint of the sequential bisection, to round-off
    lo, hi = np.log(1e6), np.log(1e8)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        m = jim.wd_mass(jim.hse_spherical(eoses["aprox13"][0], r, float(np.exp(mid)), 1e8, jx,
                                          T_of_rho=jT, rho_cutoff=1e3))
        lo, hi = (mid, hi) if m < M else (lo, mid)
    assert got["density"][0] == pytest.approx(float(np.exp(mid)), rel=1e-14)
    _same_model(got, ref, ("density", "temperature", "pressure", "mass", "spec_0", "spec_1"))


def _jax_sim(params, init):
    return JSimulation(params, problem_init=init)


def test_subchandra_model_and_init_match_jax():
    kw = dict(M_WD=0.9 * C.M_solar, M_He=0.05 * C.M_solar, pert_temp_factor=25.0)
    js = _jax_sim(j_sub.make_params(dim=1, n=16, **kw), j_sub.problem_init)
    sim = Simulation(subchandra.make_params(dim=1, n=16, **kw),
                     problem_init=subchandra.problem_init, device="cpu")
    with jitted_eos(js.eos):
        ref = j_sub.build_model(js, nshell=48)
    got = subchandra.build_model(sim, nshell=48)
    assert got["marches"] == 6  # 30 bisection steps, 5 levels a march
    _same_model(got, ref, ("density", "temperature", "pressure", "mass", "spec_0", "spec_13"))
    assert got["R_shell_base"] == ref["R_shell_base"]
    assert got["spec_13"].max() == pytest.approx(0.01)
    ju = j_sub.problem_init(js, js.allocate(), model=got)
    same_state(subchandra.problem_init(sim, sim.allocate(), model=got).numpy(), ju)


def test_massive_star_model_and_init_match_jax():
    js = _jax_sim(j_ms.make_params(n=16), j_ms.problem_init)
    sim = Simulation(massive_star.make_params(n=16), problem_init=massive_star.problem_init,
                     device="cpu")
    with jitted_eos(js.eos):
        ref = j_ms.build_model(js, nshell=96)
    got = massive_star.build_model(sim, nshell=96)
    _same_model(got, ref, ("density", "temperature", "pressure", "mass", "spec_15", "spec_8"))
    assert got["spec_15"][0] == 1.0  # the iron core
    ju = j_ms.problem_init(js, js.allocate(), model=got)
    same_state(massive_star.problem_init(sim, sim.allocate(), model=got).numpy(), ju)


@pytest.mark.parametrize("problem", [0, 1])
def test_wdmerger_models_and_init_match_jax(problem, monkeypatch):
    """Two 0.5 Msun stars of 40 shells each on 8 x 16 zones."""
    kw = dict(mass_P=0.5, mass_S=0.5, problem=problem)
    js = _jax_sim(j_wdm.make_params(n=(8, 16), **kw), j_wdm.problem_init)
    sim = Simulation(wdmerger.make_params(n=(8, 16), **kw), problem_init=wdmerger.problem_init,
                     device="cpu")
    orig = j_wdm._wd
    monkeypatch.setattr(j_wdm, "_wd", lambda s, m, T: orig(s, m, T, nshell=40))
    with jitted_eos(js.eos):
        ju = j_wdm.problem_init(js, js.allocate())
    models = (wdmerger._wd(sim, 0.5, 1e7, nshell=40) * 2)
    got = wdmerger.problem_init(sim, sim.allocate(), models=models)
    same_state(got.numpy(), ju)
    L = sim.layout
    vy = (got[L.UMY] / got[L.URHO]).numpy()
    assert (np.abs(vy).max() > 1e7) == (problem == 0)
    assert sim.params.castro.do_rotation == problem
