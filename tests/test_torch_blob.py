"""The 3D burning blob (`castro_tpu_torch/problems/burning_blob.py`, the
physics set of the JAX package's full-physics configuration without
gravity and sponge) at 16^3 for Strang steps: the port's Simulation on
the CPU against the JAX package's, gamma law here (two steps), Helmholtz
in test_torch_blob_helmholtz.py (one step: the JAX package's Helmholtz
runs op by op in its hydro phase, some 14 s a step here), float64.

Both step from the JAX initial state with the same dt. The JAX step runs
in its phases (`castro_tpu/driver/sim.py:_step_impl`, phase="burn" jitted,
which compiles the burner once for both halves, and phase="mid" op by op
under disable_jit), as burn, mid, burn; the port runs its whole step. The
port's kernel structure runs through the plain versions.

Tolerance: 1e-8 |jax| + 1e-12 max|jax| per component, interiors only (the
coupled-step budget of a stiff burn: the burner's own agreement is 1e-8,
tests/test_torch_reactions.py).
"""

import jax
import numpy as np
import pytest
import torch

from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu_torch import convert
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import burning_blob

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)

N = 16
STEPS = 2
DT = 2e-3


def _jax_init(sim, u):
    import jax.numpy as jnp

    from castro_tpu.problems.util import fill_from_prim

    r = sim.geom.radius(sim.ng, center=(0.0,) * 3)
    g = jnp.exp(-(r / 5e7) ** 2)
    return fill_from_prim(sim, u, 1e6 * g + 1e-3, (0.0, 0.0, 0.0), T=2e8 * g + 1e7)


def blob_matches_jax(eos, steps=STEPS):
    """Step both packages; return the port's simulation and the number of
    zones whose composition moved."""
    from castro_tpu.config import Params as JParams

    params = burning_blob.make_params(n=N, dtype="float64", eos=eos)
    # the same inputs for the JAX package (burning_blob.make_params)
    jp = JParams()
    jp = jp.with_ns("amr", n_cell=(N, N, N))
    jp = jp.with_ns("geometry", prob_lo=(-1e8,) * 3, prob_hi=(1e8,) * 3)
    jp = jp.with_ns("castro", lo_bc=(2, 2, 2), hi_bc=(2, 2, 2), do_grav=0, do_react=1,
                    do_sponge=0, small_dens=1e-5, small_temp=1e5)
    jp = jp.with_ns("network", network_name="iso7")
    jp = jp.with_ns("eos", eos_name=eos)
    jp = jp.with_ns("tpu", dtype="float64")
    js = JSim(jp, problem_init=_jax_init)
    js.init_data()
    burn = jax.jit(lambda u, dt, t: js._step_impl(u, dt, t, phase="burn"))
    sim = Simulation(params, problem_init=burning_blob.problem_init, device="cpu")
    sim.init_data()
    L, ng = sim.layout, sim.ng
    inner = (slice(None),) + (slice(ng, -ng),) * 3
    own = sim.interior().numpy()
    ref0 = np.asarray(js.u)[inner]
    scale = np.abs(ref0).reshape(L.NVAR, -1).max(1)[:, None, None, None]
    assert np.all(np.abs(own - ref0) <= 1e-12 * np.abs(ref0) + 1e-14 * scale)
    ju = js.u
    u = convert.state_from_numpy(np.asarray(ju), L, "cpu", sim.dtype)
    t = 0.0
    for k in range(steps):
        ju, bf1 = burn(ju, DT, t)  # the phase burns for DT / 2
        with jax.disable_jit():
            ju, _, bad = js._step_impl(ju, DT, t, phase="mid")
        ju, bf2 = burn(ju, DT, t + DT)
        assert not bool(bf1) and not bool(bf2) and not bool(bad)
        u, min_rho, flag = sim._step_impl(u, DT, t)
        assert not bool(flag) and float(min_rho) > 0.0
        ref = np.asarray(ju)[inner]
        got = sim.interior(u).numpy()
        scale = np.abs(ref).reshape(L.NVAR, -1).max(1)[:, None, None, None]
        err = np.abs(got - ref) - (1e-8 * np.abs(ref) + 1e-12 * scale)
        assert err.max() <= 0.0, (k, np.unravel_index(np.argmax(err), err.shape))
        t += DT
    moved = np.abs(got[L.UFS] / got[L.URHO] - own[L.UFS] / own[L.URHO]) > 1e-12
    return sim, int(moved.sum())


def test_blob_gamma_law_matches_jax():
    sim, moved = blob_matches_jax("gamma_law")
    assert sim.reactor is not None and sim.layout.nspec == 7
    assert moved > 0  # the hot core burned
