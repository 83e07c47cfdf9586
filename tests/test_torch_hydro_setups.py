"""The hydro test setups of the PyTorch port (`problems/hydro_tests.py`,
`riemann_2d.py`, `sod_stellar.py`) against the JAX package's on the CPU:
every setup's initial state (every riemann_2d configuration and
sod_stellar test among them) within rtol 1e-12 (the temperature of the
Helmholtz shock tubes within 1e-10: the clean's EOS inversion is a Newton
iteration, which the two packages stop within 1e-11 of each other), and
one step of each setup from the JAX initial state at a small size within
1e-10 |jax| + 1e-10 max|jax| per component (float64, interiors only):
here the 1D ones, the 2D ones in `tests/test_torch_hydro_setups_steps.py`,
the 3D torus in `tests/test_torch_hydro_setups_checks.py`, which also
holds the JAX package's physical checks of the setups, run on the port.
The JAX steps run op by op (`jax.disable_jit()`) with the JAX multigrid
jitted (`tests/test_torch_gravity.py:make_jit_poisson`) for Poisson
gravity.
"""

import jax
import numpy as np
import pytest
import torch

from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.problems import hydro_tests as jht
from castro_tpu.problems import riemann_2d as jr2
from castro_tpu.problems import sod_stellar as jss
from castro_tpu.solvers import multigrid as jmg
from castro_tpu_torch import convert
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import hydro_tests as ht
from castro_tpu_torch.problems import riemann_2d as r2
from castro_tpu_torch.problems import sod_stellar as ss
from test_torch_gravity import make_jit_poisson

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def jit_jax_poisson():
    mp = pytest.MonkeyPatch()
    mp.setattr(jmg, "poisson", make_jit_poisson())
    yield
    mp.undo()


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# name -> (module pair, params name, init name, params kwargs, dt of the step)
SETUPS = {
    "kh-1": ((jht, ht), "kh_params", "kh_init", dict(n=16, problem=1), 2e-3),
    "kh-2": ((jht, ht), "kh_params", "kh_init", dict(n=16), 2e-3),
    "rt": ((jht, ht), "rt_params", "rt_init", dict(n=(16, 32)), 2e-3),
    "noh-2d": ((jht, ht), "noh_params", "noh_init", dict(n=16), 2e-3),
    "noh-1d-spherical": ((jht, ht), "noh_params", "noh_init", dict(n=32, dim=1, coord=2),
                         2e-3),
    "gresho": ((jht, ht), "gresho_params", "gresho_init", dict(n=16), 2e-3),
    "oddeven": ((jht, ht), "oddeven_params", "oddeven_init", dict(n=16), 2e-3),
    "rotating_torus": ((jht, ht), "rotating_torus_params", "rotating_torus_init",
                       dict(n=(16, 16, 8)), 1e-3),
    "lw_acoustics": ((jht, ht), "lw_acoustics_params", "lw_acoustics_init", dict(n=16), 0.1),
}
SETUPS.update({f"riemann_2d-c{c}": ((jr2, r2), "make_params", "problem_init",
                                    dict(n=16, config=c), 2e-3) for c in sorted(r2.CONFIGS)})
SETUPS.update({f"sod_stellar-{k}": ((jss, ss), "make_params", "problem_init",
                                    dict(test=k, n=32), 1e-6) for k in sorted(ss.TESTS)})


def _pair(name):
    (jmod, tmod), pname, iname, kw, dt = SETUPS[name]
    js = JSim(getattr(jmod, pname)(**kw), problem_init=getattr(jmod, iname))
    ts = Simulation(getattr(tmod, pname)(**kw), problem_init=getattr(tmod, iname),
                    device="cpu")
    return js, ts, dt


def _close(got, ref, what, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(1).reshape((-1,) + (1,) * (ref.ndim - 1))
    np.testing.assert_array_less(np.abs(got - ref), rtol * (np.abs(ref) + scale) + 1e-300,
                                 err_msg=what)


@pytest.mark.parametrize("name", list(SETUPS))
def test_initial_state_matches_jax(name):
    js, ts, _ = _pair(name)
    js.init_data()
    ts.init_data()
    assert ts.layout.NVAR == js.layout.NVAR
    got, ref = ts.u.numpy(), np.asarray(js.u)
    rtol = np.full((ref.shape[0],) + (1,) * (ref.ndim - 1), 1e-12)
    if name.startswith("sod_stellar"):
        rtol[ts.layout.UTEMP] = 1e-10
    np.testing.assert_array_less(np.abs(got - ref), rtol * np.abs(ref) + 1e-300, err_msg=name)


def step_matches_jax(name):
    """One step of the setup `name` from the JAX initial state, both
    packages, held within 1e-10 |jax| + 1e-10 max|jax| per component."""
    js, ts, dt = _pair(name)
    with jax.disable_jit():
        js.init_data()
        ju, _, jbad = js._step_impl(js.u, dt, 0.0)
    assert not bool(jbad)
    ts.init_data()
    u0 = convert.state_from_numpy(np.asarray(js.u), ts.layout, "cpu", ts.dtype)
    u1, min_rho, bad = ts._step_impl(u0, dt, 0.0)[:3]
    assert not bool(bad) and float(min_rho) > 0.0
    inner = (slice(None),) + (slice(ts.ng, -ts.ng),) * ts.layout.dim
    _close(ts.interior(u1), np.asarray(ju)[inner], name, 1e-10)


@pytest.mark.parametrize("name", ["noh-1d-spherical", "sod_stellar-1"])
def test_step_matches_jax(name):
    step_matches_jax(name)


def test_noh_postshock_density():
    """The exact stagnated density of both packages: ((g+1)/(g-1))^dim."""
    for gamma in (5.0 / 3.0, 1.4):
        for dim in (1, 2, 3):
            assert ht.noh_postshock_density(gamma, dim) == jht.noh_postshock_density(gamma, dim)
    assert ht.noh_postshock_density(5.0 / 3.0, dim=3) == pytest.approx(64.0, rel=1e-14)
