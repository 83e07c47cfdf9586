"""The JAX package's full-physics configuration (`__graft_entry__.py:79-109`,
`_fullphys_sim`: CTU hydro, Poisson gravity with order-2 multipole BCs,
iso7 Strang reactions, the sponge) at 16^3 in float64: the port's
`burning_blob.make_params(physics="full")` against it, one step from the
JAX initial state with the same dt.

The JAX step runs in its phases as tests/test_torch_blob.py runs them
(burn jitted, mid op by op under disable_jit with the multigrid jitted as
in tests/test_torch_gravity.py, burn); the port runs its whole step, its
kernel structure through the plain versions.

Tolerance: tests/test_torch_blob.py's 1e-8 |jax| + 1e-12 max|jax| per
component, interiors only (the coupled-step budget of a stiff burn).
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from castro_tpu.solvers import multigrid as jmg

from castro_tpu_torch import convert
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import burning_blob

from test_torch_blob import _few_threads  # noqa: F401
from test_torch_gravity import make_jit_poisson

jax.config.update("jax_enable_x64", True)

N = 16
DT = 2e-3


@pytest.fixture(autouse=True, scope="module")
def jit_jax_poisson():
    mp = pytest.MonkeyPatch()
    mp.setattr(jmg, "poisson", make_jit_poisson())
    yield
    mp.undo()


def test_fullphys_blob_matches_jax():
    with jax.disable_jit():
        js = graft._fullphys_sim(n=N, dtype="float64", mesh_axes=())
    burn = jax.jit(lambda u, dt, t: js._step_impl(u, dt, t, phase="burn"))
    params = burning_blob.make_params(n=N, dtype="float64", physics="full")
    sim = Simulation(params, problem_init=burning_blob.problem_init, device="cpu")
    sim.init_data()
    assert [fn.name for fn in sim.source_fns] == ["grav", "sponge"]
    assert sim.reactor is not None
    L, ng = sim.layout, sim.ng
    inner = (slice(None),) + (slice(ng, -ng),) * 3
    ref0 = np.asarray(js.u)[inner]
    scale = np.abs(ref0).reshape(L.NVAR, -1).max(1)[:, None, None, None]
    assert np.all(np.abs(sim.interior().numpy() - ref0) <= 1e-12 * np.abs(ref0) + 1e-14 * scale)
    ju, bf1 = burn(js.u, DT, 0.0)  # the phase burns for DT / 2
    with jax.disable_jit():
        ju, _, bad = js._step_impl(ju, DT, 0.0, phase="mid")
    ju, bf2 = burn(ju, DT, DT)
    assert not bool(bf1) and not bool(bf2) and not bool(bad)
    u = convert.state_from_numpy(np.asarray(js.u), L, "cpu", sim.dtype)
    u, min_rho, flag = sim._step_impl(u, DT, 0.0)
    assert not bool(flag) and float(min_rho) > 0.0
    ref = np.asarray(ju)[inner]
    got = sim.interior(u).numpy()
    scale = np.abs(ref).reshape(L.NVAR, -1).max(1)[:, None, None, None]
    err = np.abs(got - ref) - (1e-8 * np.abs(ref) + 1e-12 * scale)
    assert err.max() <= 0.0, np.unravel_index(np.argmax(err), err.shape)
    grav = sim.source_fns[0].gravity
    assert len(grav.solve_stats) == 2
    # the burn and the gravity both acted: the hot core burned, and the
    # momenta moved (the blob starts at rest)
    assert np.abs(got[L.UFS + 1] / got[L.URHO]).max() > 0.0
    assert np.abs(got[L.UMX]).max() > 0.0
    assert torch.isfinite(u).all()
