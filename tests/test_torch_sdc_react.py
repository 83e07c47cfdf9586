"""SDC steps of reacting states, the PyTorch port against the JAX package
on the CPU: the reacting box of tests/test_reactions.py:110-140 (powerlaw,
16 zones) stepped by `try_step` in simplified SDC (time_integration_method
=3) and true SDC (2), and the 1D detonation (powerlaw, n = 64) in the three
SDC modes (3; 2 with sdc_order 2; 2 with sdc_order 4), each step held
against the JAX package's `try_step` from the same state, with its status.
(`tests/test_torch_sdc_burner.py` holds the forced burner on its own.)

Tolerance, float64: 1e-10 |jax| + 1e-10 max|jax| per component, interiors
only; the JAX steps are jitted, as the JAX package's own tests run them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from castro_tpu.config import Params as JParams
from castro_tpu.driver.sim import Simulation as JSim
from castro_tpu.problems import detonation as jdet
from castro_tpu.problems.util import fill_from_prim as j_fill_from_prim
from castro_tpu_torch import convert
from castro_tpu_torch.config import Params
from castro_tpu_torch.driver.sim import Simulation
from castro_tpu_torch.problems import detonation as det
from castro_tpu_torch.problems.util import fill_from_prim

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _box_params(params_cls, tim):
    """tests/test_reactions.py:116-126: 16 zones of powerlaw fuel at rest."""
    p = params_cls()
    p = p.with_ns("amr", n_cell=(16,))
    p = p.with_ns("geometry", prob_lo=(0.0,), prob_hi=(1.0,))
    p = p.with_ns("castro", lo_bc=(0,), hi_bc=(0,), do_react=1, time_integration_method=tim,
                  small_dens=1e-12, small_temp=1e-12, small_pres=1e-15)
    p = p.with_ns("network", network_name="powerlaw", rtilde=10.0, specific_q_burn=5.0,
                  T_burn_ref=1.0, rho_burn_ref=1.0)
    p = p.with_ns("eos", eos_gamma=1.4)
    return p.with_ns("tpu", dtype="float64")


def _close(got, ref, what):
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(1).reshape((-1,) + (1,) * (ref.ndim - 1))
    np.testing.assert_array_less(np.abs(got - ref), 1e-10 * (np.abs(ref) + scale) + 1e-300,
                                 err_msg=what)


@pytest.mark.parametrize("tim", [2, 3])
def test_sdc_burning_box_matches_jax(tim):
    """Three try_steps of 2e-3 of the reacting box, each held against the
    JAX package's; the fuel burns, the box stays at rest and uniform."""

    def jinit(sim, u):
        xn = jnp.zeros((3,) + u.shape[1:]).at[0].set(1.0)
        return j_fill_from_prim(sim, u, 1.0, (0.0, 0.0, 0.0), T=2.0, xn=xn)

    def init(sim, u):
        xn = torch.zeros((3,) + tuple(u.shape[1:]), dtype=u.dtype)
        xn[0] = 1.0
        return fill_from_prim(sim, u, 1.0, (0.0, 0.0, 0.0), T=2.0, xn=xn)

    js = JSim(_box_params(JParams, tim), problem_init=jinit)
    js.init_data()
    sim = Simulation(_box_params(Params, tim), problem_init=init, device="cpu")
    assert (sim.sdc is None) == (tim == 3) and (sim.sdc_simplified is None) == (tim == 2)
    assert sim.reactor is None
    sim.init_data()
    L, ng = sim.layout, sim.ng
    _close(sim.interior().numpy(), np.asarray(js.u)[:, ng:-ng], "init")
    x_fuel0 = float(sim.interior()[L.UFS].sum())
    _step_pair(js, sim, 2e-3, 3, f"box tim={tim}")
    ui = sim.interior().numpy()
    assert ui[L.UFS].sum() < x_fuel0
    assert np.allclose(ui[L.URHO], 1.0, rtol=1e-10)
    assert np.abs(ui[L.UMX]).max() < 1e-8


def test_ssdc_without_a_network_takes_the_ctu_step():
    """time_integration_method=3 with an inert network is the plain CTU
    step, as in the JAX package (castro_tpu/driver/sim.py:208)."""
    p = _box_params(Params, 3).with_ns("network", network_name="general_null")
    sim = Simulation(p, device="cpu")
    assert sim.sdc is None and sim.sdc_simplified is None and sim.reactor is None


def _step_pair(js, sim, dt, steps, what):
    """`steps` try_steps of both packages from the JAX state, each held
    against the other with its status."""
    L, ng = sim.layout, sim.ng
    sim.u = convert.state_from_numpy(np.asarray(js.u), L, "cpu", sim.dtype)
    for k in range(steps):
        ju, jst = js.try_step(dt)
        u, st = sim.try_step(dt)
        assert st.success and jst.success, (what, st, jst)
        assert (st.burn_fail, st.has_nan) == (jst.burn_fail, jst.has_nan)
        assert st.min_rho == pytest.approx(jst.min_rho, rel=1e-12)
        inner = (slice(None),) + (slice(ng, -ng),) * L.dim
        _close(sim.interior(u).numpy(), np.asarray(ju)[inner], f"{what} step {k + 1}")
        js.u, sim.u = ju, u


# mode -> (time_integration_method, sdc_order)
DET_MODES = {"simplified": (3, 2), "sdc2": (2, 2), "sdc4": (2, 4)}


@pytest.mark.parametrize("mode", list(DET_MODES))
def test_detonation_matches_jax(mode):
    """The 1D detonation at n = 64 for two steps at the CFL dt of its
    initial state; fuel burns in the hot zones."""
    tim, order = DET_MODES[mode]
    js = JSim(jdet.make_params(n=64, tim=tim).with_ns("castro", sdc_order=order),
              problem_init=jdet.problem_init)
    js.init_data()
    sim = Simulation(det.make_params(n=64, tim=tim).with_ns("castro", sdc_order=order),
                     problem_init=det.problem_init, device="cpu")
    sim.init_data()
    assert sim.reactor is None and (sim.sdc is None) == (tim == 3)
    dt = float(js.estimate_dt())
    assert sim.estimate_dt() == pytest.approx(dt, rel=1e-12)
    L = sim.layout
    fuel0 = float(sim.interior()[L.UFS].sum())
    _step_pair(js, sim, dt, 2, mode)
    assert float(sim.interior()[L.UFS].sum()) < fuel0
